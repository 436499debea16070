"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package, its entry points run on the card unless the caller asks
for the CPU, and features it has not ported yet raise instead of being
ignored."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.incubate.nn import PagedKVCacheManager
from paddle_tpu_torch.inference import (BatchScheduler, PagedLlamaAdapter,
                                        Request)
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name):
    return (name == "jax" or name.startswith("jax.")
            or name == "paddle_tpu" or name.startswith("paddle_tpu."))


def test_import_loads_no_jax_and_no_reference_package():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.testing\n"
            "import paddle_tpu_torch.inference, paddle_tpu_torch.models\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')]\n"
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
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    with pytest.raises(NotImplementedError):
        m(torch.zeros(1, 4, dtype=torch.long))


def test_ragged_attention_off_raises():
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    a = PagedLlamaAdapter(m, num_pages=8, page_size=4)
    a.alloc("s")
    pt.set_flags({"FLAGS_ragged_attention": "off"})
    try:
        with pytest.raises(NotImplementedError):
            a.prefill_chunk([[1, 2]], ["s"])
        with pytest.raises(NotImplementedError):
            a.decode_token([1], ["s"])
    finally:
        pt.set_flags({"FLAGS_ragged_attention": "auto"})


@pytest.mark.parametrize("kwargs", [
    {"prefix_cache": True}, {"draft_model": object()},
    {"preempt": True}, {"swap_bytes": 1 << 20},
    {"fault_injector": object()}, {"slo": object()},
    {"watchdog": object()}, {"max_queue": 4},
], ids=lambda kw: next(iter(kw)))
def test_unported_scheduler_features_raise(kwargs):
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    a = PagedLlamaAdapter(m, num_pages=8, page_size=4)
    with pytest.raises(NotImplementedError):
        BatchScheduler(a, **kwargs)


def test_unported_request_and_adapter_options_raise():
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    a = PagedLlamaAdapter(m, num_pages=8, page_size=4)
    s = BatchScheduler(a)
    with pytest.raises(NotImplementedError):
        s.submit(Request("r", [1, 2], deadline_s=1.0))
    with pytest.raises(NotImplementedError):
        PagedLlamaAdapter(m, kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError):
        PagedLlamaAdapter(m, weight_dtype="int8")
