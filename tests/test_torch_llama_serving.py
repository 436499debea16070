"""The PyTorch port's paged Llama serving slice against the JAX
package's, on ``llama_tiny``-shaped models in float32 on the CPU.

Weights are copied from the JAX model with ``from_reference_state``
(``{k: np.asarray(v._data)}`` of its state dict), so no test relies on
the two packages seeding alike. The JAX adapter's paged kernel runs in
Pallas interpret mode (its default off-TPU); the port's wrappers, handed
CPU tensors, run their plain versions.

Both adapters serve from float pools of the model's float32 (the card's
serve runs use bf16 pools) or from int8 pools, whose pages and scales
agree bit for bit (tests/test_torch_quant_kv.py), under each
``FLAGS_ragged_attention`` mode: ``auto``/``on`` (the unified ragged
kernel) and ``off`` (decode rows through the decode kernel, prefill rows
through the ragged kernel).

Tolerances: logits within 1e-4 absolute (float32 through a few layers,
products summed in another order); greedy token streams identical;
page-pool bookkeeping (tables, lengths, free list) identical.
"""
import contextlib

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import BatchScheduler as JaxScheduler
from paddle_tpu.inference import PagedLlamaAdapter as JaxAdapter
from paddle_tpu.inference import Request as JaxRequest
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import (BatchScheduler, PagedLlamaAdapter,
                                        Request, bucket_packed_tokens)
from paddle_tpu_torch.inference.serving import _parse_buckets
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.testing import dense_reference_logits

PAGE = 4
ATOL = 1e-4
VARIANTS = {
    "base": {},
    "window6": {"sliding_window": 6},
    "qkv_bias": {"attention_bias": True},
}

_MODELS = {}


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


def _pair(variant):
    """(jax_model, port_model) with identical weights, built once."""
    if variant not in _MODELS:
        kw = dict(hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128,
                  **VARIANTS[variant])
        paddle.seed(11)
        jm = JaxLlama(jax_tiny(**kw))
        state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
        tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
        tm.load_reference_state(state)
        _MODELS[variant] = (jm, tm)
    return _MODELS[variant]


_RNG = np.random.RandomState(0)
PROMPTS = {"a": _RNG.randint(1, 500, 11).tolist(),
           "b": _RNG.randint(1, 500, 3).tolist(),
           "c": _RNG.randint(1, 500, 7).tolist(),
           "d": _RNG.randint(1, 500, 14).tolist()}
N_NEW = {"a": 4, "b": 6, "c": 3, "d": 5}


def _pools_equal(jax_adapter, port_adapter):
    for jc, tc in zip(jax_adapter.caches, port_adapter.caches):
        assert jc._tables == tc._tables
        assert jc._lens == tc._lens
        assert jc._free == tc._free


def _serve_both(variant, chunked, budget=5, kv_cache_dtype=None):
    """Step the two schedulers in lockstep over 4 interleaved requests
    (two submitted late), checking the pools after every step."""
    jm, tm = _pair(variant)
    ja = JaxAdapter(jm, num_pages=64, page_size=PAGE, max_length=128,
                    kv_cache_dtype=kv_cache_dtype)
    ta = PagedLlamaAdapter(tm, num_pages=64, page_size=PAGE,
                           max_length=128, kv_cache_dtype=kv_cache_dtype)
    js = JaxScheduler(ja, max_batch_size=3, chunked_prefill=chunked,
                      prefill_chunk_tokens=budget)
    ts = BatchScheduler(ta, max_batch_size=3, chunked_prefill=chunked,
                        prefill_chunk_tokens=budget)
    for rid in ("a", "b"):
        js.submit(JaxRequest(rid, PROMPTS[rid], max_new_tokens=N_NEW[rid]))
        ts.submit(Request(rid, PROMPTS[rid], max_new_tokens=N_NEW[rid]))
    steps = 0
    while js.num_active or js.num_queued or ts.num_active or ts.num_queued:
        if steps == 2:
            for rid in ("c", "d"):
                js.submit(JaxRequest(rid, PROMPTS[rid],
                                     max_new_tokens=N_NEW[rid]))
                ts.submit(Request(rid, PROMPTS[rid],
                                  max_new_tokens=N_NEW[rid]))
        jev, tev = js.step(), ts.step()
        for k in ("admitted", "advanced", "finished", "prefill_tokens",
                  "decode_tokens"):
            assert jev[k] == tev[k], (k, jev, tev)
        _pools_equal(ja, ta)
        steps += 1
        assert steps < 200
    return ({r: js.result(r).generated_ids for r in PROMPTS},
            {r: ts.result(r).generated_ids for r in PROMPTS}, ja, ta, ts)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("chunked", [True, False])
def test_greedy_streams_identical(variant, chunked):
    jax_out, port_out, ja, ta, ts = _serve_both(variant, chunked)
    assert port_out == jax_out
    assert all(len(port_out[r]) == N_NEW[r] for r in PROMPTS)
    # every page returned to the pool, free lists in the same order
    _pools_equal(ja, ta)
    stats = ts.page_pool_stats()
    assert stats["free_pages"] == stats["total_pages"]
    if chunked:
        assert ta.compile_count == ja.compile_count
        assert ta.attend_program_count == ja.attend_program_count


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("chunked", [True, False])
def test_greedy_streams_identical_by_pool_and_mode(chunked, mode, kv):
    """{float, int8} pools x {auto, on, off} x chunked on and off: the
    same tokens, pools and (chunked) attention-program accounting as the
    reference, per bucket too."""
    with ragged_mode(mode):
        jax_out, port_out, ja, ta, ts = _serve_both(
            "base", chunked, kv_cache_dtype=None if kv == "float" else kv)
    assert port_out == jax_out
    assert all(len(port_out[r]) == N_NEW[r] for r in PROMPTS)
    assert ta.caches[0].quantized == ja.caches[0].quantized
    if chunked:
        assert ta.compile_count == ja.compile_count
        assert ta.attend_program_count == ja.attend_program_count
        assert ta.attend_kinds_by_bucket == ja.attend_kinds_by_bucket
        kinds = set().union(*map(set, ta.attend_kinds_by_bucket.values()))
        want = {"off": {"decode", "prefill"}, "on": {"ragged"},
                "auto": {"ragged" if kv == "int8" else "ragged_fused"}}
        assert kinds == want[mode]


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_chunk_logits_match(variant, mode):
    """Mixed ragged chunks (multi-token prefill rows beside decode
    rows, resuming mid-page) through the fused (auto), unfused (on) and
    two-kernel (off) branches; plus the per-position logits epilogue."""
    _prefill_chunk_logits_match(variant, mode, None)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("variant", ["base", "window6"])
def test_int8_prefill_chunk_logits_match(variant, mode):
    _prefill_chunk_logits_match(variant, mode, "int8")


def _prefill_chunk_logits_match(variant, mode, kv_cache_dtype):
    jm, tm = _pair(variant)
    ja = JaxAdapter(jm, num_pages=32, page_size=PAGE, max_length=128,
                    kv_cache_dtype=kv_cache_dtype)
    ta = PagedLlamaAdapter(tm, num_pages=32, page_size=PAGE,
                           max_length=128, kv_cache_dtype=kv_cache_dtype)
    for s in ("x", "y", "z"):
        ja.alloc(s)
        ta.alloc(s)
    rng = np.random.RandomState(5)
    chunks = [([5, 3, 7], None), ([1, 6, 2], [1]), ([1, 1, 9], [2, 0])]
    with ragged_mode(mode):
        for counts, rows in chunks:
            toks = [rng.randint(0, 512, c).tolist() for c in counts]
            starts = [ta.caches[0].seq_len(s) for s in ("x", "y", "z")]
            pad = bucket_packed_tokens(sum(counts))
            j = ja.prefill_chunk(toks, ["x", "y", "z"], starts, pad_to=pad,
                                 logits_rows=rows)
            t = ta.prefill_chunk(toks, ["x", "y", "z"], starts,
                                 pad_to=pad, logits_rows=rows)
            if rows is None:
                j, t = (j,), (t,)
            for jj, tt in zip(j, t):
                np.testing.assert_allclose(tt.numpy(),
                                           np.asarray(jj._data),
                                           atol=ATOL, rtol=0)
            _pools_equal(ja, ta)
    assert ta.attend_program_count == ja.attend_program_count
    assert ta.attend_kinds_by_bucket == ja.attend_kinds_by_bucket


def test_decode_token_logits_match():
    jm, tm = _pair("base")
    ja = JaxAdapter(jm, num_pages=16, page_size=PAGE, max_length=64)
    ta = PagedLlamaAdapter(tm, num_pages=16, page_size=PAGE, max_length=64)
    for s in ("p", "q"):
        ja.alloc(s)
        ta.alloc(s)
    rng = np.random.RandomState(6)
    for _ in range(6):
        toks = rng.randint(0, 512, 2).tolist()
        j = ja.decode_token(toks, ["p", "q"])
        t = ta.decode_token(toks, ["p", "q"])
        np.testing.assert_allclose(t.numpy(), np.asarray(j._data),
                                   atol=ATOL, rtol=0)
    _pools_equal(ja, ta)


@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_decode_token_logits_match_by_pool_and_mode(kv, mode):
    """decode_token through the pool's decode attend: the ragged kernel
    at T=1, or under ``off`` the decode kernel, on float or int8 pages."""
    jm, tm = _pair("window6")
    kw = dict(num_pages=16, page_size=PAGE, max_length=64,
              kv_cache_dtype=None if kv == "float" else kv)
    ja, ta = JaxAdapter(jm, **kw), PagedLlamaAdapter(tm, **kw)
    for s in ("p", "q"):
        ja.alloc(s)
        ta.alloc(s)
    rng = np.random.RandomState(8)
    with ragged_mode(mode):
        for _ in range(9):
            toks = rng.randint(0, 512, 2).tolist()
            j = ja.decode_token(toks, ["p", "q"])
            t = ta.decode_token(toks, ["p", "q"])
            np.testing.assert_allclose(t.numpy(), np.asarray(j._data),
                                       atol=ATOL, rtol=0)
    _pools_equal(ja, ta)


def test_equal_hbm_budget_doubles_capacity():
    """At the byte budget of a bf16 pool, int8 pages (with their scale
    rows) hold at least 1.8x the pages, and the port sizes the pool as
    the reference does."""
    jm, tm = _pair("base")
    import jax.numpy as jnp
    import torch

    fp = PagedLlamaAdapter(tm, num_pages=32, page_size=PAGE,
                           dtype=torch.bfloat16)
    budget = sum(c.pool_nbytes for c in fp.caches)
    q = PagedLlamaAdapter(tm, page_size=PAGE, kv_cache_dtype="int8",
                          page_pool_bytes=budget)
    jq = JaxAdapter(jm, page_size=PAGE, kv_cache_dtype="int8",
                    page_pool_bytes=budget)
    jfp = JaxAdapter(jm, num_pages=32, page_size=PAGE, dtype=jnp.bfloat16)
    assert budget == sum(c.pool_nbytes for c in jfp.caches)
    assert q.caches[0].num_pages == jq.caches[0].num_pages
    assert sum(c.pool_nbytes for c in q.caches) <= budget
    assert q.caches[0].num_pages / fp.caches[0].num_pages >= 1.8
    assert q.caches[0].quantized and q.caches[0].k_pages.dtype == torch.int8


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_oracle_matches_jax_forward(variant):
    jm, tm = _pair(variant)
    ids = np.random.RandomState(7).randint(0, 512, (2, 12))
    want = np.asarray(jm(paddle.to_tensor(ids))._data)
    got = dense_reference_logits(tm, ids).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    sub = dense_reference_logits(tm, ids, positions=[3, 11]).numpy()
    np.testing.assert_allclose(sub, want[:, [3, 11]], atol=ATOL, rtol=0)


def test_served_logits_match_the_oracle():
    """Teacher-forced: the logits a served request sampled each token
    from equal the dense oracle's at those positions."""
    _, tm = _pair("window6")
    ta = PagedLlamaAdapter(tm, num_pages=32, page_size=PAGE,
                           max_length=128)
    seen = {}
    serve = ta.prefill_chunk

    def recording(token_ids, seq_ids, start_positions=None, pad_to=None,
                  logits_rows=None):
        out = serve(token_ids, seq_ids, start_positions, pad_to=pad_to)
        for i, s in enumerate(seq_ids):
            seen[(s, start_positions[i] + len(token_ids[i]) - 1)] = out[i]
        return out

    ta.prefill_chunk = recording
    ts = BatchScheduler(ta, max_batch_size=2, prefill_chunk_tokens=4)
    ts.submit(Request("a", PROMPTS["a"], max_new_tokens=5))
    ts.submit(Request("d", PROMPTS["d"], max_new_tokens=3))
    ts.run_until_complete()
    for rid in ("a", "d"):
        r = ts.result(rid)
        seq = r.prompt_ids + r.generated_ids[:-1]
        pos = list(range(len(r.prompt_ids) - 1, len(seq)))
        ref = dense_reference_logits(tm, seq, positions=pos)[0]
        for k, p in enumerate(pos):
            np.testing.assert_allclose(seen[(rid, p)].numpy(),
                                       ref[k].numpy(), atol=ATOL, rtol=0)
            assert int(ref[k].argmax()) == r.generated_ids[k]


def test_bucket_helpers_match_reference():
    from paddle_tpu.inference import bucket_packed_tokens as jax_bucket
    from paddle_tpu.inference.serving import _parse_buckets as jax_parse

    for spec in ("8,16,32", "64, 8 ,16", (3, 1, 2)):
        assert _parse_buckets(spec) == jax_parse(spec)
    for n in (1, 7, 8, 9, 100, 256, 257, 1000):
        assert bucket_packed_tokens(n) == jax_bucket(n)


def test_admission_waits_for_pages_like_reference():
    """A pool too small for every request at once: admission holds the
    FIFO head back on the watermark in both packages alike."""
    jm, tm = _pair("base")
    ja = JaxAdapter(jm, num_pages=9, page_size=PAGE, max_length=128)
    ta = PagedLlamaAdapter(tm, num_pages=9, page_size=PAGE, max_length=128)
    js = JaxScheduler(ja, max_batch_size=4, prefill_chunk_tokens=6)
    ts = BatchScheduler(ta, max_batch_size=4, prefill_chunk_tokens=6)
    for rid in ("a", "b", "c"):
        js.submit(JaxRequest(rid, PROMPTS[rid], max_new_tokens=N_NEW[rid]))
        ts.submit(Request(rid, PROMPTS[rid], max_new_tokens=N_NEW[rid]))
    admitted = []
    while js.num_active or js.num_queued:
        jev, tev = js.step(), ts.step()
        assert jev["admitted"] == tev["admitted"]
        admitted.append(tev["admitted"])
        _pools_equal(ja, ta)
    assert {r: js.result(r).generated_ids for r in ("a", "b", "c")} == \
        {r: ts.result(r).generated_ids for r in ("a", "b", "c")}
    assert admitted[0] < 3  # the watermark held someone back
