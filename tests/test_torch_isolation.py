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
from paddle_tpu_torch import jit
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
    """The dense forward runs now (the flash kernels are ported), under
    recompute too; what recompute still refuses raises: an unknown
    granularity (``ValueError``, as the reference) and offloading
    (``NotImplementedError``)."""
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    assert tuple(m(torch.zeros(1, 4, dtype=torch.long)).shape) == (
        1, 4, 512)
    rc = LlamaForCausalLM(llama_tiny(num_hidden_layers=1, recompute=True),
                          device="cpu")
    assert tuple(rc(torch.zeros(1, 4, dtype=torch.long)).shape) == (
        1, 4, 512)
    bogus = LlamaForCausalLM(llama_tiny(num_hidden_layers=1, recompute=True,
                                        recompute_granularity="bogus"),
                             device="cpu")
    with pytest.raises(ValueError, match="granularity"):
        bogus(torch.zeros(1, 4, dtype=torch.long))
    from paddle_tpu_torch.distributed.fleet.recompute import recompute
    with pytest.raises(NotImplementedError):
        recompute(m.model.layers[0].mlp, torch.zeros(1, 4, 128),
                  offload_indices=[0])


def test_scan_covers_the_training_slice():
    """The AST scan walks the whole package, so the training slice's
    modules are among the files it checks."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in ("optimizer/adamw.py", "optimizer/optimizer.py",
                "nn/functional/loss.py", "nn/functional/flash_attention.py",
                "incubate/nn/functional.py", "ops/kernels/fused_loss.py",
                "ops/kernels/flash_attention.py") + SLICE_16:
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
    # soft labels with an ignore_index or a class weight: the reference
    # accepts both there and reads neither
    lambda: pt.nn.functional.cross_entropy(
        torch.zeros(2, 3), torch.zeros(2, 3), soft_label=True,
        ignore_index=1),
    lambda: pt.nn.functional.cross_entropy(
        torch.zeros(2, 3), torch.zeros(2, 3), soft_label=True,
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


class _Stub:
    def __init__(self, **config):
        self.config = types.SimpleNamespace(**config)


def _stub(name, **config):
    return type(name, (_Stub,), {})(**config)


@pytest.mark.parametrize("call", [
    # generate(use_jit=True) is ported; what stays unported of the
    # compiled path is exporting the program
    lambda m: jit.save(m, "unused"),
    lambda m: from_hf(_stub("LlamaForCausalLM", num_local_experts=8), {}),
    lambda m: from_hf(_stub("BertModel"), {}),
    lambda m: from_hf(_stub("GPTForCausalLM"), {}),
    lambda m: from_hf(_stub("VisionTransformer"), {}),
    lambda m: from_hf(_stub("T5ForConditionalGeneration"), {}),
], ids=["use_jit", "mixtral", "bert", "gpt", "vit", "t5"])
def test_unported_generation_and_loader_options_raise(call):
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    with pytest.raises(NotImplementedError):
        call(m)


def test_from_hf_refuses_an_unknown_family():
    with pytest.raises(TypeError):
        from_hf(_stub("ResNet50"), {})


@pytest.mark.parametrize("name", ["BertModel", "VisionTransformer",
                                  "T5ForConditionalGeneration"])
def test_from_hf_refuses_weight_dtype_for_an_encoder_family(name):
    # the reference's ValueError (a serving knob of the decoder
    # families) comes before the unported loader's NotImplementedError
    with pytest.raises(ValueError, match="weight_dtype"):
        from_hf(_stub(name), {}, weight_dtype="int8")


def test_parameter_group_keys_other_than_params_raise():
    from paddle_tpu_torch.optimizer import AdamW

    p = torch.nn.Parameter(torch.ones(2))
    AdamW(0.1, parameters=[{"params": [p]}])
    with pytest.raises(NotImplementedError, match="learning_rate"):
        AdamW(0.1, parameters=[{"params": [p], "learning_rate": 0.5}])


@pytest.mark.parametrize("coeff", [0.0, 0.01])
def test_a_parameter_regularizer_raises(coeff):
    # no optimizer of the port (nor of the reference) reads a
    # parameter's own regularizer: the port refuses it at construction
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.regularizer import L2Decay

    plain = pt.nn.RMSNorm(4, device="cpu")
    AdamW(0.1, parameters=plain.parameters())
    norm = pt.nn.RMSNorm(4, weight_attr=pt.nn.ParamAttr(
        regularizer=L2Decay(coeff)), device="cpu")
    with pytest.raises(NotImplementedError, match="regularizer"):
        AdamW(0.1, parameters=[{"params": list(plain.parameters())},
                               {"params": list(norm.parameters())}])


@pytest.mark.parametrize("attr", [
    lambda: pt.nn.ParamAttr(initializer=object()),
    lambda: pt.nn.ParamAttr(name="w"), lambda: "w", lambda: False,
], ids=["initializer", "name", "str", "no_weight"])
def test_unported_param_attr_options_raise(attr):
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers import (
        ColumnParallelLinear)

    with pytest.raises(NotImplementedError):
        ColumnParallelLinear(4, 4, weight_attr=attr(), device="cpu")
    if not isinstance(attr(), (str, bool)):
        with pytest.raises(NotImplementedError):
            pt.nn.RMSNorm(4, weight_attr=attr(), device="cpu")


SLICE_16 = ("distributed/fleet/recompute/recompute.py",
            "distributed/fleet/recompute/__init__.py", "framework/io.py",
            "optimizer/momentum.py", "optimizer/extra.py",
            "optimizer/functional.py")


def test_scan_covers_recompute_io_and_the_other_optimizers():
    """Recompute, save/load and the other optimizers are among the files
    the AST scan checks, and importing them and training a recomputed
    step, saving and loading its state and stepping each optimizer loads
    no JAX and nothing of the JAX package."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in SLICE_16:
        assert f"paddle_tpu_torch/{rel}" in scanned
    code = ("import os, sys, tempfile, torch\n"
            "import paddle_tpu_torch as pt\n"
            "import paddle_tpu_torch.optimizer as opt\n"
            "from paddle_tpu_torch.models import LlamaForCausalLM, "
            "llama_tiny\n"
            "m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1, "
            "recompute=True, recompute_granularity='selective'), "
            "device='cpu')\n"
            "x = torch.zeros(1, 4, dtype=torch.long)\n"
            "for cls in ('Momentum', 'Lamb', 'NAdam', 'Rprop'):\n"
            "    o = getattr(opt, cls)(0.01, parameters=m.parameters())\n"
            "    m(x, x)[1].backward()\n"
            "    o.step()\n"
            "    o.clear_grad()\n"
            "d = tempfile.mkdtemp()\n"
            "pt.save(o.state_dict(), os.path.join(d, 's'))\n"
            "o.set_state_dict(pt.load(os.path.join(d, 's'), device='cpu'))\n"
            "print([m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


SLICE_15 = ("ops/kernels/quant.py", "nn/quant/__init__.py",
            "quantization/__init__.py", "quantization/ptq_llm.py",
            "optimizer/lr.py", "nn/clip.py", "regularizer.py",
            "nn/param_attr.py")


def test_scan_covers_quantized_serving_and_the_training_options():
    """Weight-only quantization, the LR schedulers, the clips, the
    regularizers and ParamAttr are among the files the AST scan checks,
    and importing them and serving an int8-weight model loads no JAX and
    nothing of the JAX package."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in SLICE_15:
        assert f"paddle_tpu_torch/{rel}" in scanned
    code = ("import sys\n"
            "import paddle_tpu_torch.nn.quant, paddle_tpu_torch.quantization\n"
            "import paddle_tpu_torch.optimizer.lr, paddle_tpu_torch.nn.clip\n"
            "import paddle_tpu_torch.regularizer\n"
            "import paddle_tpu_torch.nn.param_attr\n"
            "from paddle_tpu_torch.models import LlamaForCausalLM, "
            "llama_tiny\n"
            "from paddle_tpu_torch.inference import BatchScheduler, "
            "PagedLlamaAdapter, Request\n"
            "m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), "
            "device='cpu')\n"
            "s = BatchScheduler(PagedLlamaAdapter(m, num_pages=8, "
            "page_size=4, weight_dtype='int4'))\n"
            "s.submit(Request('a', [1, 2, 3], max_new_tokens=2))\n"
            "s.run_until_complete()\n"
            "print([m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


SERVING_FRONTS = ("inference/engine.py", "inference/disagg.py",
                  "framework/ops_server.py", "framework/autotuner.py")


def test_scan_covers_the_serving_fronts():
    """The engine, disaggregated serving, the ops server and the
    autotuner are among the files the AST scan checks, and importing and
    driving them (an engine with the ops server armed and a router over
    one disaggregated replica) loads no JAX and nothing of the JAX
    package."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in SERVING_FRONTS:
        assert f"paddle_tpu_torch/{rel}" in scanned
    code = (
        "import asyncio, sys\n"
        "from paddle_tpu_torch.framework import flags, ops_server\n"
        "from paddle_tpu_torch.framework import autotuner\n"
        "flags.set_flags({'FLAGS_telemetry': 'metrics'})\n"
        "srv = ops_server.maybe_start(port=0)\n"
        "flags.set_flags({'FLAGS_ops_server_port': srv.port})\n"
        "from paddle_tpu_torch.models import LlamaForCausalLM, "
        "llama_tiny\n"
        "from paddle_tpu_torch.inference import (BatchScheduler, "
        "DisaggReplica, PagedLlamaAdapter, Request, ServingEngine, "
        "SessionRouter)\n"
        "m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), "
        "device='cpu')\n"
        "mk = lambda: BatchScheduler(PagedLlamaAdapter(m, num_pages=16, "
        "page_size=4), preempt=True, swap_bytes=1 << 24)\n"
        "async def main():\n"
        "    async with ServingEngine(mk()) as eng:\n"
        "        r = SessionRouter([DisaggReplica('r0', mk(), eng)])\n"
        "        s = await r.submit(Request('a', [1, 2, 3], "
        "max_new_tokens=3))\n"
        "        return await s.tokens()\n"
        "assert len(asyncio.run(main())) == 3\n"
        "ops_server.stop()\n"
        "print([m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_ops_server_imports_only_the_standard_library_and_the_port():
    """``framework/ops_server.py`` is a stdlib HTTP surface: every import
    is a standard-library module or a module of the port (relative)."""
    path = ROOT / "paddle_tpu_torch" / "framework" / "ops_server.py"
    tree = ast.parse(path.read_text(), str(path))
    seen = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level > 0:
                continue  # the port's own modules
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            seen.add(top)
            assert top in sys.stdlib_module_names, \
                f"ops_server.py:{node.lineno} imports {n}"
    assert {"http", "json", "threading"} <= seen


# calls an ``async def`` of the serving fronts must not make: each blocks
# the event loop (a sleep, a lock acquire, file IO, a device sync)
_BLOCKING = {("time", "sleep"), ("torch.cuda", "synchronize"),
             ("cuda", "synchronize")}


def _blocking_calls(fn):
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("open", "sleep"):
            out.append((node.lineno, f.id))
        elif isinstance(f, ast.Attribute):
            base = ast.unparse(f.value)
            if f.attr == "acquire" or (base, f.attr) in _BLOCKING \
                    or (f.attr == "synchronize" and "cuda" in base):
                out.append((node.lineno, f"{base}.{f.attr}"))
    return out


@pytest.mark.parametrize("rel", ["inference/engine.py",
                                 "inference/disagg.py"])
def test_async_defs_never_block_the_loop(rel):
    """The reference's blocking-async rule: no ``async def`` of the
    engine or of disaggregated serving calls ``time.sleep``, a lock's
    ``acquire``, ``open`` or ``torch.cuda.synchronize``."""
    path = ROOT / "paddle_tpu_torch" / rel
    tree = ast.parse(path.read_text(), str(path))
    fns = [n for n in ast.walk(tree) if isinstance(n, ast.AsyncFunctionDef)]
    assert len(fns) >= 5
    bad = [(fn.name,) + c for fn in fns for c in _blocking_calls(fn)]
    assert not bad, bad


def test_blocking_async_rule_catches_each_call():
    """The rule's checker flags each forbidden call."""
    for body in ("time.sleep(1)", "self._lock.acquire()", "open('x')",
                 "torch.cuda.synchronize()", "sleep(0.1)"):
        tree = ast.parse(f"async def f(self):\n    {body}\n")
        assert _blocking_calls(tree.body[0]), body
    ok = ast.parse("async def f(self):\n    await asyncio.sleep(0)\n")
    assert not _blocking_calls(ok.body[0])


SLICE_18 = ("distributed/env.py", "distributed/collective.py",
            "distributed/stream.py", "distributed/object_collectives.py",
            "distributed/parallel.py", "distributed/spawn.py",
            "distributed/launch/main.py", "distributed/launch/__main__.py",
            "distributed/fleet/fleet.py",
            "distributed/fleet/base/topology.py",
            "distributed/fleet/base/distributed_strategy.py",
            "distributed/fleet/layers/mpu/mp_ops.py",
            "distributed/fleet/layers/mpu/mp_layers.py",
            "distributed/fleet/meta_parallel/tensor_parallel.py",
            "distributed/fleet/meta_parallel/meta_parallel_base.py",
            "distributed/fleet/meta_parallel/parallel_layers/random.py",
            "distributed/fleet/meta_optimizers/dygraph_optimizer/"
            "hybrid_parallel_optimizer.py",
            "distributed/fleet/utils/hybrid_parallel_util.py")


def test_scan_covers_the_distributed_slice():
    """The distributed modules are among the files the AST scan checks,
    and importing them, joining a world of one over gloo and training a
    step through fleet's wrappers loads no JAX and nothing of the JAX
    package (the launcher and spawned ranks import the same modules)."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in SLICE_18:
        assert f"paddle_tpu_torch/{rel}" in scanned
    code = ("import sys, torch\n"
            "import paddle_tpu_torch.distributed as dist\n"
            "import paddle_tpu_torch.distributed.launch.main\n"
            "from paddle_tpu_torch.distributed import fleet\n"
            "from paddle_tpu_torch.models import LlamaForCausalLM, "
            "llama_tiny\n"
            "from paddle_tpu_torch.optimizer import AdamW\n"
            "dist.init_parallel_env(device='cpu')\n"
            "fleet.init(is_collective=True)\n"
            "m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1, "
            "fused_head_loss=True), device='cpu')\n"
            "o = fleet.distributed_optimizer(AdamW(0.01, "
            "parameters=m.parameters()))\n"
            "x = torch.zeros(1, 4, dtype=torch.long)\n"
            "fleet.distributed_model(m)(x, x)[1].backward()\n"
            "o.step()\n"
            "dist.destroy_process_group()\n"
            "print([m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
