"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package (the host planes included), its entry points run on the
card unless the caller asks for the CPU, and features it has not ported
yet raise instead of being ignored."""
import ast
import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.incubate.nn import PagedKVCacheManager
from paddle_tpu_torch.inference import PagedLlamaAdapter
from paddle_tpu_torch.models import (LlamaForCausalLM, from_hf, generate,
                                     llama_tiny)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name):
    return (name == "jax" or name.startswith("jax.")
            or name == "paddle_tpu" or name.startswith("paddle_tpu.")
            or name == "transformers" or name.startswith("transformers."))


def test_import_loads_no_jax_and_no_reference_package():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.testing\n"
            "import paddle_tpu_torch.inference, paddle_tpu_torch.models\n"
            "import paddle_tpu_torch.models.generation\n"
            "import paddle_tpu_torch.models.convert\n"
            "import paddle_tpu_torch.ops.kernels.flash_varlen\n"
            "import paddle_tpu_torch.optimizer\n"
            "import paddle_tpu_torch.incubate.nn.functional\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.') or m == 'transformers' or "
            "m.startswith('transformers.')]\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_model_defaults_to_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(llama_tiny(num_hidden_layers=1))
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    assert m.device.type == "cpu"


def test_pool_defaults_to_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCacheManager(4, 4, 2, 32)
    assert PagedKVCacheManager(4, 4, 2, 32, device="cpu").k_pages.is_cpu


def test_device_api(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.get_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.set_device("gpu")
    try:
        assert str(pt.set_device("cpu")) == "cpu"
        assert pt.get_device() == "cpu"
    finally:
        pt.device._current = None


def test_adapter_follows_the_model_device():
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    a = PagedLlamaAdapter(m, num_pages=8, page_size=4)
    assert all(c.k_pages.is_cpu for c in a.caches)
    assert a._cos.is_cpu


def test_dense_forward_waits_for_the_flash_kernel():
    """The dense forward runs now (the flash kernels are ported); what
    it still waits for, recompute, raises."""
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    assert tuple(m(torch.zeros(1, 4, dtype=torch.long)).shape) == (
        1, 4, 512)
    with pytest.raises(NotImplementedError):
        LlamaForCausalLM(llama_tiny(num_hidden_layers=1, recompute=True),
                         device="cpu")


def test_scan_covers_the_training_slice():
    """The AST scan walks the whole package, so the training slice's
    modules are among the files it checks."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in ("optimizer/adamw.py", "optimizer/optimizer.py",
                "nn/functional/loss.py", "nn/functional/flash_attention.py",
                "incubate/nn/functional.py", "ops/kernels/fused_loss.py",
                "ops/kernels/flash_attention.py"):
        assert f"paddle_tpu_torch/{rel}" in scanned


def test_scan_covers_the_int8_and_decode_slice():
    """The int8 KV helpers and the decode kernel's modules are among the
    files the import check and the AST scan cover."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in ("ops/kernels/quant.py", "ops/kernels/paged_attention.py",
                "incubate/nn/paged_cache.py", "inference/paged_llama.py"):
        assert f"paddle_tpu_torch/{rel}" in scanned
    code = ("import sys, paddle_tpu_torch.ops.kernels.quant\n"
            "print([m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_scan_covers_the_varlen_and_layer_norm_slice():
    """The packed-attention and LayerNorm modules are among the files the
    AST scan checks, and the CUDA sources include only each other and
    the toolkit's headers."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in ("ops/kernels/flash_varlen.py", "ops/kernels/rms_norm.py",
                "nn/functional/flash_attention.py"):
        assert f"paddle_tpu_torch/{rel}" in scanned
    csrc = ROOT / "paddle_tpu_torch" / "ops" / "kernels" / "csrc"
    local = {p.name for p in csrc.iterdir()}
    assert {"flash_varlen.cu", "flash_tiles.cuh"} <= local
    for src in sorted(csrc.iterdir()):
        for line in src.read_text().splitlines():
            if line.startswith("#include"):
                name = line.split()[1]
                assert name.startswith("<") or name.strip('"') in local, \
                    f"{src.name}: {line}"


HOST_PLANES = ("framework/concurrency.py", "framework/telemetry.py",
               "framework/perf_ledger.py", "framework/flight_recorder.py",
               "framework/watchdog.py", "incubate/nn/page_sanitizer.py",
               "incubate/nn/fault_injection.py")


def test_scan_covers_the_host_planes():
    """The host planes (telemetry, SLO accounting, watchdog, ledger,
    flight recorder, sanitizers, fault injection) are among the files
    the AST scan checks; importing them, and driving a scheduler with
    every plane on, loads no JAX and nothing of the JAX package; and
    chip_smoke.py imports nothing of the JAX package."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in HOST_PLANES:
        assert f"paddle_tpu_torch/{rel}" in scanned
    mods = [f"paddle_tpu_torch.{rel[:-3].replace('/', '.')}"
            for rel in HOST_PLANES]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "from paddle_tpu_torch.framework import flags\n"
            "flags.set_flags({'FLAGS_telemetry': 'trace', "
            "'FLAGS_page_sanitizer': 'strict', "
            "'FLAGS_concurrency_sanitizer': 'strict', "
            "'FLAGS_telemetry_watchdog': 'warn', "
            "'FLAGS_serving_faults': 'exhaust@2+1'})\n"
            "from paddle_tpu_torch.models import LlamaForCausalLM, "
            "llama_tiny\n"
            "from paddle_tpu_torch.inference import BatchScheduler, "
            "PagedLlamaAdapter, Request\n"
            "m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), "
            "device='cpu')\n"
            "s = BatchScheduler(PagedLlamaAdapter(m, num_pages=8, "
            "page_size=4))\n"
            "s.submit(Request('a', [1, 2, 3], max_new_tokens=2))\n"
            "s.run_until_complete()\n"
            "assert s.metrics()['serving']['steps'] >= 2\n"
            "print([m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(n == "paddle_tpu" or n.startswith("paddle_tpu.")
                       for n in names), f"chip_smoke.py:{node.lineno}"


@pytest.mark.parametrize("call", [
    lambda: pt.nn.functional.cross_entropy(
        torch.zeros(2, 3), torch.zeros(2, 3), soft_label=True),
    lambda: pt.nn.functional.cross_entropy(
        torch.zeros(2, 3), torch.zeros(2, dtype=torch.long),
        weight=torch.ones(3)),
    lambda: pt.nn.functional.flash_attention(
        *[torch.zeros(1, 4, 2, 64)] * 3, dropout=0.5),
    lambda: pt.nn.functional.flash_attn_unpadded(
        *[torch.zeros(4, 2, 64)] * 3, *[torch.tensor([0, 4])] * 2,
        dropout=0.5),
], ids=["soft_label", "class_weight", "dropout", "varlen_dropout"])
def test_unported_training_options_raise(call):
    with pytest.raises(NotImplementedError):
        call()


def test_unported_request_and_adapter_options_raise():
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    with pytest.raises(NotImplementedError):
        PagedLlamaAdapter(m, weight_dtype="int8")


class _Stub:
    def __init__(self, **config):
        self.config = types.SimpleNamespace(**config)


def _stub(name, **config):
    return type(name, (_Stub,), {})(**config)


@pytest.mark.parametrize("call", [
    lambda m: generate(m, torch.zeros(1, 2, dtype=torch.long),
                       use_jit=True),
    lambda m: from_hf(m, {}, weight_dtype="int8"),
    lambda m: from_hf(_stub("LlamaForCausalLM", num_local_experts=8), {}),
    lambda m: from_hf(_stub("BertModel"), {}),
    lambda m: from_hf(_stub("GPTForCausalLM"), {}),
    lambda m: from_hf(_stub("VisionTransformer"), {}),
    lambda m: from_hf(_stub("T5ForConditionalGeneration"), {}),
], ids=["use_jit", "weight_dtype", "mixtral", "bert", "gpt", "vit", "t5"])
def test_unported_generation_and_loader_options_raise(call):
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    with pytest.raises(NotImplementedError):
        call(m)


def test_from_hf_refuses_an_unknown_family():
    with pytest.raises(TypeError):
        from_hf(_stub("ResNet50"), {})


def test_from_hf_takes_no_group_size():
    # group_size only shapes quantize-on-load, which is not ported: the
    # loader does not accept it rather than ignore it
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    with pytest.raises(TypeError):
        from_hf(m, {}, group_size=32)
