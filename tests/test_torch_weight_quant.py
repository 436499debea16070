"""Weight-only int8/int4 quantized serving in the PyTorch port against the
JAX package's, on the CPU.

The same numpy weights (seeded) go through both packages' quantizers;
models move from the JAX package through ``load_reference_state``, so no
test relies on the two packages seeding alike. Each test builds its own
models: quantization swaps the linears in place.

Tolerances: int8 and int4 payloads and scales bit for bit; dequantized
weights and ``weight_only_matmul`` outputs within 1e-6 relative (the
same float32 products, summed in another order by the matmul); logits
of quantized llama_tiny models within 1e-4 absolute (float32 through two
layers, as tests/test_torch_llama_serving.py); greedy tokens and page
books equal; ``quantize_for_serving`` reports equal key for key.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import BatchScheduler as JaxScheduler
from paddle_tpu.inference import PagedLlamaAdapter as JaxAdapter
from paddle_tpu.inference import Request as JaxRequest
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu.models.convert import from_hf as jax_from_hf
import paddle_tpu.nn.quant as jax_nnq
from paddle_tpu.ops.kernels import quant as JQ
from paddle_tpu.quantization import WeightOnlyLinear as JaxWOL
from paddle_tpu.quantization import quantize_for_serving as jax_qfs

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.quant as nnq
from paddle_tpu_torch.inference import (BatchScheduler, PagedLlamaAdapter,
                                        Request)
from paddle_tpu_torch.models import LlamaForCausalLM, from_hf, llama_tiny
from paddle_tpu_torch.ops.kernels import quant as Q
from paddle_tpu_torch.quantization import (DEFAULT_SKIP_PATTERNS,
                                           WeightOnlyLinear,
                                           quantize_for_serving)
from paddle_tpu_torch.testing import dense_reference_logits

RTOL = 1e-6
ATOL = 1e-4
SHAPES = [(64, 48), (128, 96), (256, 32)]


def _w(shape, seed, dtype="float32"):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    # one channel of zeros: its scale takes the 1e-9 floor
    w[:, 1] = 0.0
    if dtype == "bfloat16":
        return jnp.asarray(w, jnp.bfloat16), torch.from_numpy(w).to(
            torch.bfloat16)
    return jnp.asarray(w), torch.from_numpy(w)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, rtol=RTOL):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale


# -- the quant functions -------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_int8_payload_and_scale_bit_for_bit(shape, dtype):
    jw, tw = _w(shape, 0, dtype)
    jq, js = JQ.quantize_int8(jw)
    tq, ts = Q.quantize_int8(tw)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    _close(Q.dequantize_int8(tq, ts), JQ.dequantize_int8(jq, js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [64, 32, -1, 0])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_int4_payload_and_scale_bit_for_bit(shape, group, dtype):
    jw, tw = _w(shape, 1, dtype)
    jp, js = JQ.quantize_int4(jw, group)
    tp, ts = Q.quantize_int4(tw, group)
    assert tp.dtype == torch.uint8 and tp.shape == (shape[0] // 2, shape[1])
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    _close(Q.dequantize_int4(tp, ts, group),
           JQ.dequantize_int4(jp, js, group))


def test_pack_unpack_every_nibble():
    vals = np.arange(-8, 8, dtype=np.int8)
    q = np.stack(np.meshgrid(vals, vals, indexing="ij"), 0).reshape(2, -1)
    q = np.repeat(q, 3, axis=0)                      # [6, 256]
    tp = Q.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(_np(tp), np.asarray(JQ.pack_int4(q)))
    # row 2i in the low nibble, row 2i + 1 in the high one
    lo, hi = q[0].astype(np.uint8) & 0xF, q[1].astype(np.uint8) & 0xF
    np.testing.assert_array_equal(_np(tp)[0], (hi << 4) | lo)
    np.testing.assert_array_equal(_np(Q.unpack_int4(tp)), q)
    np.testing.assert_array_equal(
        _np(Q.unpack_int4(tp)), np.asarray(JQ.unpack_int4(jnp.asarray(
            _np(tp)))))


def test_odd_int4_group_raises():
    for q in (Q, JQ):
        with pytest.raises(ValueError, match="even group_size"):
            q.quantize_int4(np.zeros((64, 8), np.float32) if q is JQ
                            else torch.zeros(64, 8), 3)
        with pytest.raises(ValueError, match="even group_size"):
            q.quantize_int4(np.zeros((64, 8), np.float32) if q is JQ
                            else torch.zeros(64, 8), 48)


@pytest.mark.parametrize("wd,group", [("int8", -1), ("int4", 32),
                                      ("int4", -1)])
@pytest.mark.parametrize("bias", [False, True])
def test_weight_only_matmul_matches(wd, group, bias):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 128).astype(np.float32)
    b = rng.randn(96).astype(np.float32) if bias else None
    jw, tw = _w((128, 96), 3)
    jq, js = (JQ.quantize_int8(jw) if wd == "int8"
              else JQ.quantize_int4(jw, group))
    tq, ts = (Q.quantize_int8(tw) if wd == "int8"
              else Q.quantize_int4(tw, group))
    want = JQ.weight_only_matmul(jnp.asarray(x), jq, js, bias=b,
                                 weight_dtype=wd, group_size=group)
    got = Q.weight_only_matmul(torch.from_numpy(x), tq, ts,
                               bias=None if b is None else
                               torch.from_numpy(b), weight_dtype=wd,
                               group_size=group)
    assert got.shape == (2, 5, 96) and got.dtype == torch.float32
    _close(got, want)
    # the numpy oracles agree, and hold the kernel-free path
    ref = Q.weight_only_matmul_reference(x.reshape(10, 128), _np(tw), wd,
                                         group)
    np.testing.assert_array_equal(ref, JQ.weight_only_matmul_reference(
        x.reshape(10, 128), np.asarray(jw), wd, group))
    _close(got.reshape(10, 96) - (0 if b is None else torch.from_numpy(b)),
           ref, rtol=1e-5)


def test_weight_only_matmul_keeps_the_input_dtype():
    tq, ts = Q.quantize_int8(_w((64, 48), 4)[1])
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    assert Q.weight_only_matmul(x.bfloat16(), tq, ts).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="int8\\|int4"):
        Q.weight_only_matmul(x, tq, ts, weight_dtype="int2")


# -- nn.quant ------------------------------------------------------------

@pytest.mark.parametrize("algo,group", [("weight_only_int8", -1),
                                        ("int8", -1),
                                        ("weight_only_int4", 32),
                                        ("int4", -1)])
def test_nn_quant_surface_matches(algo, group):
    rng = np.random.RandomState(5)
    w = rng.randn(64, 40).astype(np.float32)
    x = rng.randn(3, 64).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    jq, js = jax_nnq.weight_quantize(paddle.to_tensor(w), algo,
                                     group_size=group)
    tq, ts = nnq.weight_quantize(torch.from_numpy(w), algo,
                                 group_size=group)
    np.testing.assert_array_equal(_np(tq), jq.numpy())
    np.testing.assert_array_equal(_np(ts), js.numpy())
    _close(nnq.weight_dequantize(tq, ts, algo, group_size=group),
           jax_nnq.weight_dequantize(jq, js, algo, group_size=group).numpy())
    wd = "int8" if algo.endswith("int8") else "int4"
    want = jax_nnq.weight_only_linear(paddle.to_tensor(x), jq,
                                      bias=paddle.to_tensor(b),
                                      weight_scale=js, weight_dtype=wd,
                                      group_size=group).numpy()
    got = nnq.weight_only_linear(torch.from_numpy(x), tq,
                                 bias=torch.from_numpy(b), weight_scale=ts,
                                 weight_dtype=wd, group_size=group)
    _close(got, want)


def test_unscaled_int8_is_the_grid_and_int4_needs_a_scale():
    q = np.random.RandomState(6).randint(-127, 128, (16, 8)).astype(np.int8)
    x = np.random.RandomState(7).randn(2, 16).astype(np.float32)
    want = jax_nnq.weight_only_linear(paddle.to_tensor(x),
                                      paddle.to_tensor(q)).numpy()
    got = nnq.weight_only_linear(torch.from_numpy(x), torch.from_numpy(q))
    _close(got, want)
    _close(got, x @ q.astype(np.float32))
    with pytest.raises(ValueError, match="weight_scale is required"):
        nnq.weight_only_linear(torch.from_numpy(x), torch.from_numpy(q),
                               weight_dtype="int4")
    with pytest.raises(ValueError, match="unsupported weight-only algo"):
        nnq.weight_quantize(torch.zeros(4, 4), "fp8")


# -- WeightOnlyLinear ----------------------------------------------------

def _linear_pair(din, dout, bias, seed=8):
    """A JAX ColumnParallelLinear and the port's with the same weights."""
    from paddle_tpu.distributed.fleet.layers.mpu.mp_layers import (
        ColumnParallelLinear as JaxCol)
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers import (
        ColumnParallelLinear)

    rng = np.random.RandomState(seed)
    jl = JaxCol(din, dout, has_bias=bias, gather_output=False)
    jl.weight._data = jnp.asarray(rng.randn(din, dout).astype(np.float32))
    tl = ColumnParallelLinear(din, dout, has_bias=bias, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.asarray(jl.weight._data)))
        if bias:
            b = rng.randn(dout).astype(np.float32)
            jl.bias._data = jnp.asarray(b)
            tl.bias.copy_(torch.from_numpy(b))
    return jl, tl


@pytest.mark.parametrize("din,wd,group,want", [
    (64, "int8", 64, ("int8", -1)), (64, "int4", 64, ("int4", 64)),
    (96, "int4", 64, ("int4", 96)),            # 64 does not divide 96
    (33, "int4", 64, ("int8", -1)),            # odd: degrades to int8
])
def test_from_linear_matches(din, wd, group, want):
    jl, tl = _linear_pair(din, 24, bias=True)
    jw = JaxWOL.from_linear(jl, weight_dtype=wd, group_size=group)
    tw = WeightOnlyLinear.from_linear(tl, weight_dtype=wd, group_size=group)
    assert (tw.weight_dtype, tw.group_size) == want
    assert (jw.weight_dtype, jw.group_size) == want
    np.testing.assert_array_equal(_np(tw.qweight), np.asarray(jw.qweight._data))
    np.testing.assert_array_equal(_np(tw.weight_scale),
                                  np.asarray(jw.weight_scale._data))
    assert tw.weight_nbytes() == jw.weight_nbytes()
    assert tw.extra_repr() == jw.extra_repr()
    assert set(tw.state_dict()) == {"qweight", "weight_scale", "bias"}
    x = np.random.RandomState(9).randn(4, din).astype(np.float32)
    _close(tw(torch.from_numpy(x)), jw(paddle.to_tensor(x)).numpy())
    with pytest.raises(ValueError, match="int8\\|int4"):
        WeightOnlyLinear(4, 4, tw.qweight, tw.weight_scale,
                         weight_dtype="fp8")


# -- quantize_for_serving on llama_tiny ----------------------------------

_KW = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128)


def _pair(seed=3, **over):
    """(jax_model, port_model) with identical weights, built anew."""
    kw = dict(_KW, **over)
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny(**kw))
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
    tm.load_reference_state(state)
    return jm, tm


_IDS = np.random.RandomState(0).randint(1, 200, (2, 10))


@pytest.mark.parametrize("wd,group", [("int8", 64), ("int4", 64),
                                      ("int4", 32), ("int4", -1)])
@pytest.mark.parametrize("variant", [{}, {"attention_bias": True},
                                     {"tie_word_embeddings": True}],
                         ids=["base", "qkv_bias", "tied"])
def test_quantize_for_serving_report_and_logits(wd, group, variant):
    jm, tm = _pair(**variant)
    jrep = jax_qfs(jm, weight_dtype=wd, group_size=group)
    trep = quantize_for_serving(tm, weight_dtype=wd, group_size=group)
    assert trep == jrep
    assert trep["layers"] == 14
    att = tm.model.layers[0].self_attn
    assert isinstance(att.q_proj, WeightOnlyLinear)
    assert not hasattr(att.q_proj, "weight")
    # embedding and head keep their float weights
    assert tm.model.embed_tokens.weight.dtype == torch.float32
    for (jn, jb), (tn, tb) in zip(sorted(jm.state_dict().items()),
                                  sorted(tm.state_dict().items())):
        assert jn == tn
        np.testing.assert_array_equal(_np(tb), np.asarray(jb._data))
    want = jm(paddle.to_tensor(_IDS)).numpy()
    got = tm(torch.from_numpy(_IDS))
    np.testing.assert_allclose(_np(got), want, atol=ATOL)
    # the float32 oracle reads the dequantized weights
    np.testing.assert_allclose(_np(dense_reference_logits(tm, _IDS)), want,
                               atol=ATOL)


def test_quantize_for_serving_is_idempotent_and_refuses_nothing():
    jm, tm = _pair()
    quantize_for_serving(tm)
    jax_qfs(jm)
    with pytest.raises(ValueError, match="no quantizable"):
        quantize_for_serving(tm)
    with pytest.raises(ValueError, match="no quantizable"):
        jax_qfs(jm)
    _, tm2 = _pair()
    with pytest.raises(ValueError, match="no quantizable"):
        quantize_for_serving(tm2, skip_patterns=DEFAULT_SKIP_PATTERNS
                             + ("layers",))
    assert isinstance(tm2.model.layers[0].mlp.up_proj.weight, torch.Tensor)


def test_quantize_for_serving_refuses_model_parallel_linears():
    _, tm = _pair()
    tm.model.layers[1].mlp.down_proj.mp_degree = 2
    with pytest.raises(NotImplementedError, match="mp>1"):
        quantize_for_serving(tm)


# -- quantize on load ----------------------------------------------------

def _hf_state(jm):
    """The JAX model's weights as an HF checkpoint holds them."""
    sd = {}
    for name, p in jm.state_dict().items():
        a = np.asarray(p._data)
        if name.endswith(".weight") and a.ndim == 2 \
                and "embed_tokens" not in name:
            a = a.T
        sd[name] = a
    return sd


@pytest.mark.parametrize("wd,group", [("int8", 64), ("int4", 32)])
def test_from_hf_quantizes_on_load(wd, group):
    jm, _ = _pair()
    sd = _hf_state(jm)
    paddle.seed(7)
    jq = jax_from_hf(JaxLlama(jax_tiny(**_KW)), sd, weight_dtype=wd,
                     group_size=group)
    tq = from_hf(LlamaForCausalLM(llama_tiny(**_KW), device="cpu", seed=5),
                 sd, weight_dtype=wd, group_size=group)
    assert tq._hf_quant_report == jq._hf_quant_report
    jtypes = [type(m).__name__ for _, m in jq.named_sublayers()]
    ttypes = [type(m).__name__ for _, m in tq.named_modules()][1:]
    assert [t for t in ttypes if t == "WeightOnlyLinear"] == \
        [t for t in jtypes if t == "WeightOnlyLinear"]
    for name, m in tq.named_modules():
        if isinstance(m, WeightOnlyLinear):
            jmod = dict(jq.named_sublayers())[name]
            assert isinstance(jmod, JaxWOL)
            np.testing.assert_array_equal(_np(m.qweight),
                                          np.asarray(jmod.qweight._data))
    np.testing.assert_allclose(_np(tq(torch.from_numpy(_IDS))),
                               jq(paddle.to_tensor(_IDS)).numpy(), atol=ATOL)
    # without weight_dtype the loader keeps float weights and no report
    tf = from_hf(LlamaForCausalLM(llama_tiny(**_KW), device="cpu"), sd)
    assert not hasattr(tf, "_hf_quant_report")


# -- serving ---------------------------------------------------------------

@contextlib.contextmanager
def ragged_mode(mode):
    """FLAGS_ragged_attention set in both packages, restored after."""
    pt.set_flags({"FLAGS_ragged_attention": mode})
    paddle.set_flags({"FLAGS_ragged_attention": mode})
    try:
        yield
    finally:
        pt.set_flags({"FLAGS_ragged_attention": "auto"})
        paddle.set_flags({"FLAGS_ragged_attention": "auto"})


def _pools_equal(ja, ta):
    for jc, tc in zip(ja.caches, ta.caches):
        assert jc._tables == tc._tables
        assert jc._lens == tc._lens
        assert jc._free == tc._free


def _serve_lockstep(kv, wq, chunked, group=None):
    """The reference's end-to-end pin (3 requests of 6 tokens, 6 new,
    batch 3, 48 pages of 4) served by both schedulers in lockstep:
    the same step events and page books after every step."""
    jm, tm = _pair()
    kw = dict(num_pages=48, page_size=4, kv_cache_dtype=kv, weight_dtype=wq)
    ja, ta = JaxAdapter(jm, **kw), PagedLlamaAdapter(tm, **kw)
    assert ta.quant_report == ja.quant_report
    assert ta.weight_dtype == wq
    js = JaxScheduler(ja, max_batch_size=3, chunked_prefill=chunked)
    ts = BatchScheduler(ta, max_batch_size=3, chunked_prefill=chunked)
    rng = np.random.RandomState(0)
    for i in range(3):
        prompt = rng.randint(1, 256, 6).tolist()
        js.submit(JaxRequest(f"r{i}", prompt, max_new_tokens=6))
        ts.submit(Request(f"r{i}", prompt, max_new_tokens=6))
    steps = 0
    while js.num_active or js.num_queued or ts.num_active or ts.num_queued:
        jev, tev = js.step(), ts.step()
        for k in ("admitted", "advanced", "finished", "prefill_tokens",
                  "decode_tokens"):
            assert jev[k] == tev[k], (k, jev, tev)
        _pools_equal(ja, ta)
        steps += 1
        assert steps < 100
    return ({f"r{i}": js.result(f"r{i}").generated_ids for i in range(3)},
            {f"r{i}": ts.result(f"r{i}").generated_ids for i in range(3)},
            ja, ta)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("chunked", [True, False])
def test_int8_weights_and_int8_pages_serve_in_lockstep(mode, chunked):
    with ragged_mode(mode):
        jax_out, port_out, ja, ta = _serve_lockstep("int8", "int8", chunked)
    assert port_out == jax_out
    assert all(len(v) == 6 for v in port_out.values())
    assert ta.quant_report["layers"] == 14
    assert not ta._fusion_eligible() and not ja._fusion_eligible()
    if chunked:
        assert ta.attend_kinds_by_bucket == ja.attend_kinds_by_bucket


@pytest.mark.parametrize("wq", ["int8", "int4"])
@pytest.mark.parametrize("mode", ["auto", "off"])
def test_quantized_weights_on_float_pages_serve_in_lockstep(wq, mode):
    with ragged_mode(mode):
        jax_out, port_out, ja, ta = _serve_lockstep(None, wq, True)
    assert port_out == jax_out
    kinds = set().union(*map(set, ta.attend_kinds_by_bucket.values()))
    # the fused step is refused under quantized weights
    assert kinds == ({"ragged"} if mode == "auto" else {"decode",
                                                        "prefill"})


def test_int8_serving_reproduces_the_float_tokens():
    # the reference's acceptance pin, on the port alone: int8 weights
    # and int8 pages give the float model's greedy tokens
    _, fp, _, _ = _serve_lockstep(None, None, True)
    _, q, _, ta = _serve_lockstep("int8", "int8", True)
    assert q == fp
    assert ta.caches[0].quantized


def test_fused_gate_refuses_quantized_weights():
    _, tm = _pair()
    ad = PagedLlamaAdapter(tm, num_pages=8, page_size=4)
    assert ad._fusion_eligible()
    _, tm = _pair()
    ad = PagedLlamaAdapter(tm, num_pages=8, page_size=4, weight_dtype="int8")
    assert not ad._fusion_eligible()
    # quantized before the adapter: no weight_dtype, but the projections
    # have no 2-D weight for the fused step to read
    _, tm = _pair()
    quantize_for_serving(tm, weight_dtype="int4")
    ad = PagedLlamaAdapter(tm, num_pages=8, page_size=4)
    assert ad.weight_dtype is None and not ad._fusion_eligible()


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_quantized_prefill_chunk_and_window_logits_match(mode):
    jm, tm = _pair()
    ja = JaxAdapter(jm, num_pages=32, page_size=4, weight_dtype="int4")
    ta = PagedLlamaAdapter(tm, num_pages=32, page_size=4,
                           weight_dtype="int4")
    rng = np.random.RandomState(5)
    for s in ("x", "y"):
        ja.alloc(s)
        ta.alloc(s)
    with ragged_mode(mode):
        for counts in ([5, 3], [1, 6], [1, 1]):
            toks = [rng.randint(0, 256, c).tolist() for c in counts]
            starts = [ta.caches[0].seq_len(s) for s in ("x", "y")]
            j = ja.prefill_chunk(toks, ["x", "y"], starts)
            t = ta.prefill_chunk(toks, ["x", "y"], starts)
            np.testing.assert_allclose(_np(t), np.asarray(j), atol=ATOL)
        j = ja.decode_token([3, 4], ["x", "y"])
        t = ta.decode_token([3, 4], ["x", "y"])
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=ATOL)
        win = rng.randint(0, 256, (2, 3))
        j = ja.decode_window(win, ["x", "y"])
        t = ta.decode_window(win, ["x", "y"])
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=ATOL)
