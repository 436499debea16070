"""Weight carry-over into the port's models.

From the reference package (:func:`from_reference_state`): the port
keeps the reference's parameter names and its [in, out] linear layout,
so a reference state dict maps 1:1; only the array type changes. Arrays
arrive as numpy (bfloat16 arrays of the ``ml_dtypes`` kind are read
through their 16-bit pattern, so no extra package is needed).

From HuggingFace checkpoints (:func:`from_hf`, the Llama family:
Llama-2/3, Qwen2, Mistral): HF's key names already match, and 2-D
projection weights transpose from HF's [out, in]. Each tensor is copied
into its parameter in place, one at a time, so the device never holds a
second copy of the model. ``weight_dtype=`` quantizes the loaded
model's linears for serving.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_reference_state(np_state, device, dtype, splits=None):
    """``{name: np.ndarray}`` -> ``{name: torch.Tensor}`` on ``device``
    in ``dtype`` (floating arrays only are cast). ``splits`` maps a name
    to the ``mp_split`` of the parameter it fills (tensor parallelism:
    the tensor keeps that rank's slice of the whole array)."""
    from ..distributed.fleet.layers.mpu.mp_layers import mp_shard

    splits = splits or {}
    out = {}
    for name, arr in np_state.items():
        t = mp_shard(_to_tensor(np.asarray(arr)), splits.get(name))
        if t.is_floating_point():
            t = t.to(dtype)
        out[name] = t.to(device)
    return out


def _strict_report(state_dict, used, own, filled, skip=None):
    """The strict-mode contract: every checkpoint key is ``used`` (minus
    keys the ``skip`` predicate waves through) and every model parameter
    name in ``own`` is ``filled``; raises ``KeyError`` otherwise."""
    leftovers = [k for k in state_dict if k not in used
                 and not (skip and skip(k))]
    if leftovers:
        raise KeyError(f"convert: unused HF keys {leftovers[:5]}"
                       f"{'...' if len(leftovers) > 5 else ''}")
    missing = [n for n in own if n not in filled]
    if missing:
        raise KeyError(
            f"convert: checkpoint has no weights for "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''}")


def _assign(param, src, name, transpose=False):
    """Copies ``src`` (a torch tensor on any device, or a numpy array),
    transposed when asked, into ``param`` in place, cast to its dtype:
    the device holds at most ``src`` beside the model."""
    if not isinstance(src, torch.Tensor):
        src = _to_tensor(np.asarray(src))
    shape = tuple(src.shape[::-1] if transpose else src.shape)
    if shape != tuple(param.shape):
        raise ValueError(
            f"convert: shape mismatch for {name!r}: checkpoint {shape} vs "
            f"model {tuple(param.shape)}")
    src = src.detach().to(param.device)
    with torch.no_grad():
        param.copy_(src.t() if transpose else src)


def _llama_strict_leftovers(state_dict, own, model):
    """Every parameter of ``own`` in the checkpoint, and every checkpoint
    key a parameter's, apart from the tied head's ``lm_head.weight`` and
    the rotary buffers."""
    tied = model.lm_head is None
    _strict_report(
        state_dict, own, own, state_dict,
        skip=lambda k: (tied and k == "lm_head.weight")
        or k.endswith("rotary_emb.inv_freq"))


def load_hf_llama(model, state_dict, strict=True):
    """Loads a HF-format Llama-family state dict (torch tensors of any
    float dtype on any device, or numpy arrays) into a port
    ``LlamaForCausalLM``. Key names match; 2-D weights other than the
    embedding transpose from [out, in]. With tied embeddings the head
    reads the embedding and ``lm_head.weight`` is ignored. ``strict``
    raises ``KeyError`` for a missing or an unused key before anything
    is copied; a shape mismatch raises ``ValueError`` either way."""
    own = model.state_dict()
    if strict:
        _llama_strict_leftovers(state_dict, own, model)
    for name, param in own.items():
        if name not in state_dict:
            continue
        src = state_dict[name]
        transpose = (name.endswith(".weight") and len(src.shape) == 2
                     and "embed_tokens" not in name)
        _assign(param, src, name, transpose=transpose)
    return model


def from_hf(model, state_dict, strict=True, weight_dtype=None,
            group_size=64):
    """Loads a HF state dict into ``model``, dispatching on its family.
    The port loads the Llama family only (Llama-2/3, Qwen2, Mistral:
    :func:`load_hf_llama`).

    ``weight_dtype="int8"|"int4"``: quantize on load for serving. After
    the float weights land, every attention and MLP linear is abs-max
    quantized and swapped for a ``WeightOnlyLinear``
    (``quantization/ptq_llm.py``, int4 in groups of ``group_size``), and
    the report is kept as ``model._hf_quant_report``. It is a knob of
    the decoder families only."""
    name = type(model).__name__
    if name.startswith("Llama"):
        if getattr(model.config, "num_local_experts", 0) > 0:
            raise NotImplementedError(
                "from_hf: the Mixtral loader is not ported yet (ROADMAP "
                "queue 1 item 20)")
        model = load_hf_llama(model, state_dict, strict=strict)
        return _maybe_quantize(model, weight_dtype, group_size)
    if name.startswith("GPT"):
        raise NotImplementedError(
            f"from_hf: the {name} loader is not ported yet (ROADMAP "
            "queue 1, slice 4)")
    if weight_dtype is not None:
        raise ValueError(
            f"from_hf: weight_dtype={weight_dtype!r} is a serving "
            f"knob for the decoder families (Llama*/GPT*), not {name}")
    if name.startswith(("Bert", "ViT", "T5")) \
            or name == "VisionTransformer":
        raise NotImplementedError(
            f"from_hf: the {name} loader is not ported yet (ROADMAP "
            "queue 1, slice 4)")
    raise TypeError(f"from_hf: no converter for {name} (supported: "
                    "Llama*)")


def _maybe_quantize(model, weight_dtype, group_size):
    if weight_dtype is None:
        return model
    from ..quantization import quantize_for_serving

    model._hf_quant_report = quantize_for_serving(
        model, weight_dtype=weight_dtype, group_size=group_size)
    return model
