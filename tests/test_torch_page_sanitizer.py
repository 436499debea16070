"""The port's KV page-pool sanitizer (paddle_tpu_torch/incubate/nn/
page_sanitizer.py), by the reference's own unit tests: shadow-heap
lifecycle checking over the port's paged pool (on the CPU, with
``device="cpu"``).

Acceptance matrix:

* every violation class — use-after-free, double-free, refcount-leak,
  cow-write-shared, stale-page-table, capacity-drift — has a
  seeded-injected-bug test that strict mode CATCHES and whose dumped
  journal ``--replay`` reconstructs to the same violation;
* ``off`` mode allocates no shadow objects and adds zero allocations
  to the pool's hot paths (tracemalloc-verified);
* warn mode reports without raising, and the pool's own double-free
  KeyError carries the journal tail;
* the BatchScheduler epoch cross-check runs at the flag stride and
  strict serving output is identical to off;
* the fuzzer entry point is deterministic, clean on a healthy pool,
  and catches injected bugs (the checker has teeth).

Left out: the static-check inventory of ``framework.analysis`` (the
jaxpr lint). The reference marks the fuzzer's full injection matrix
and the ``python -m`` entry point slow; on the port's CPU pool they
take seconds and run in the fast tier.
"""
import json
import os
import tracemalloc

import numpy as np
import pytest
import torch

from paddle_tpu_torch.framework.flags import flag, set_flags
from paddle_tpu_torch.incubate.nn import PagedKVCacheManager
from paddle_tpu_torch.incubate.nn.page_sanitizer import (
    INJECTIONS,
    VIOLATIONS,
    PageSanitizerError,
    fuzz_pool,
    main as sanitizer_main,
    replay_journal,
)

HEADS, DIM = 2, 4


def kv(n, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).uniform(
        -1.0, 1.0, (n, HEADS, DIM)).astype("float32"))


def make_pool(mode="strict", num_pages=16, page_size=4, **kw):
    return PagedKVCacheManager(num_pages, page_size, HEADS, DIM,
                               kv_dtype="float32", sanitizer=mode,
                               device="cpu", **kw)


def assert_replays(pool, rule, tmp_path, name="journal.jsonl"):
    """The dumped journal must reconstruct the SAME violation."""
    path = pool.sanitizer.dump(str(tmp_path / name))
    res = replay_journal(path)
    assert not res.clean, "replay missed the recorded violation"
    assert res.error.rule == rule, (
        f"replay found {res.error.rule!r}, live run found {rule!r}")
    assert res.applied <= res.total
    assert "journal tail" in str(res.error)
    return res


# ---------------------------------------------------------------------------
# one seeded injected bug per violation class: caught + replayable
# ---------------------------------------------------------------------------


class TestViolationClasses:
    def test_use_after_free_attach_to_freed_chain(self, tmp_path):
        pool = make_pool()
        pool.alloc("a")
        pool.append_ragged(["a"], [4], kv(4), kv(4))
        chain = pool.seq_pages("a")
        pool.free("a")  # chain pages return to the pool
        with pytest.raises(PageSanitizerError) as ei:
            pool.attach("b", chain, 4)
        assert ei.value.rule == "use-after-free"
        assert_replays(pool, "use-after-free", tmp_path)

    def test_use_after_free_skipped_incref_generation(self, tmp_path):
        # the flagship bug: the prefix tree "holds" a chain it
        # never referenced; the page is freed + recycled under it and
        # the generation check at match time catches the staleness
        from paddle_tpu_torch.inference.prefix_cache import RadixPrefixCache

        class SkipIncref(PagedKVCacheManager):
            def incref(self, pages):  # BUG: refs dropped on the floor
                pass

        pool = SkipIncref(16, 4, HEADS, DIM, kv_dtype="float32",
                          sanitizer="strict", device="cpu")
        tree = RadixPrefixCache([pool])
        pool.alloc("src")
        pool.append_ragged(["src"], [4], kv(4), kv(4))
        tree.insert([1, 2, 3, 4], [pool.seq_pages("src")])
        pool.free("src")            # nothing holds the page now
        pool.alloc("thief")
        pool.append_ragged(["thief"], [4], kv(4), kv(4))  # recycled
        with pytest.raises(PageSanitizerError) as ei:
            tree.match([1, 2, 3, 4])
        assert ei.value.rule == "use-after-free"
        assert "recycled" in str(ei.value)
        assert_replays(pool, "use-after-free", tmp_path)

    def test_double_free(self, tmp_path):
        pool = make_pool()
        pool.alloc("a")
        pool.append_ragged(["a"], [5], kv(5), kv(5))
        pool.free("a")
        with pytest.raises(PageSanitizerError) as ei:
            pool.free("a")
        assert ei.value.rule == "double-free"
        assert_replays(pool, "double-free", tmp_path)

    def test_refcount_leak(self, tmp_path):
        class LeakyFree(PagedKVCacheManager):
            def _drop_refs(self, pages):  # BUG: never releases
                pass

        pool = LeakyFree(16, 4, HEADS, DIM, kv_dtype="float32",
                         sanitizer="strict", device="cpu")
        pool.alloc("a")
        pool.append_ragged(["a"], [4], kv(4), kv(4))
        with pytest.raises(PageSanitizerError) as ei:
            pool.free("a")
        assert ei.value.rule == "refcount-leak"
        assert_replays(pool, "refcount-leak", tmp_path)

    def test_cow_write_shared(self, tmp_path):
        class SkipFork(PagedKVCacheManager):
            def _needs_fork(self, page):  # BUG: fork dropped
                return False

        pool = SkipFork(16, 4, HEADS, DIM, kv_dtype="float32",
                        sanitizer="strict", device="cpu")
        pool.alloc("a")
        pool.append_ragged(["a"], [6], kv(6), kv(6))  # partial tail
        pool.attach("b", pool.seq_pages("a"), 6)      # tail shared
        with pytest.raises(PageSanitizerError) as ei:
            pool.append("a", kv(1)[0], kv(1)[0])      # needed a fork
        assert ei.value.rule == "cow-write-shared"
        assert_replays(pool, "cow-write-shared", tmp_path)

    def test_stale_page_table(self, tmp_path):
        class StaleTable(PagedKVCacheManager):
            def _padded_kernel_inputs(self, seq_ids, rows_pad,
                                      max_pages):  # BUG: memoized
                memo = self.__dict__.setdefault("_memo", {})
                key = tuple(seq_ids)
                if key not in memo:
                    memo[key] = super()._padded_kernel_inputs(
                        seq_ids, rows_pad, max_pages)
                return memo[key]

        pool = StaleTable(16, 4, HEADS, DIM, kv_dtype="float32",
                          sanitizer="strict", device="cpu")
        pool.alloc("a")
        pool.append_ragged(["a"], [2], kv(2), kv(2))
        pool.page_table(["a"])                        # memoized here
        pool.append_ragged(["a"], [4], kv(4), kv(4))  # spans a page
        with pytest.raises(PageSanitizerError) as ei:
            pool.page_table(["a"])
        assert ei.value.rule == "stale-page-table"
        assert_replays(pool, "stale-page-table", tmp_path)

    def test_capacity_drift(self, tmp_path):
        pool = make_pool()
        pool.alloc("a")
        pool.append_ragged(["a"], [4], kv(4), kv(4))
        pool._free.pop()  # out-of-band page theft
        with pytest.raises(PageSanitizerError) as ei:
            pool.sanitizer_crosscheck()
        assert ei.value.rule == "capacity-drift"
        assert_replays(pool, "capacity-drift", tmp_path)


# ---------------------------------------------------------------------------
# modes and ergonomics
# ---------------------------------------------------------------------------


class TestModes:
    def test_off_mode_allocates_nothing(self):
        pool = make_pool(mode="off")
        assert pool.sanitizer is None
        assert pool.sanitizer_stats is None
        assert pool.sanitizer_crosscheck() is None
        pool.alloc("a")
        # zero allocations attributed to page_sanitizer.py across the
        # hot paths (the module IS imported in this process)
        from paddle_tpu_torch.incubate.nn import page_sanitizer as ps_mod

        tracemalloc.start()
        snap0 = tracemalloc.take_snapshot()
        for _ in range(3):
            pool.append_batch(["a"], kv(1), kv(1))
        pool.page_table(["a"])
        snap1 = tracemalloc.take_snapshot()
        tracemalloc.stop()
        filt = [tracemalloc.Filter(True, ps_mod.__file__)]
        diff = snap1.filter_traces(filt).compare_to(
            snap0.filter_traces(filt), "filename")
        assert sum(max(d.count_diff, 0) for d in diff) == 0

    def test_default_flag_is_off(self):
        assert flag("page_sanitizer") == "off"
        pool = PagedKVCacheManager(8, 4, HEADS, DIM,
                                   kv_dtype="float32", device="cpu")
        assert pool.sanitizer is None

    def test_warn_mode_reports_and_continues(self):
        pool = make_pool(mode="warn")
        pool.alloc("a")
        pool.append_ragged(["a"], [4], kv(4), kv(4))
        chain = pool.seq_pages("a")
        pool.free("a")
        with pytest.warns(RuntimeWarning, match="use-after-free"):
            with pytest.raises(ValueError, match="free list"):
                pool.attach("b", chain, 4)
        assert pool.sanitizer.violations >= 1

    def test_double_free_keyerror_carries_journal_tail(self):
        # satellite: the EXISTING KeyError gets the new ergonomics
        # outside strict mode too
        pool = make_pool(mode="warn")
        pool.alloc("a")
        pool.append_ragged(["a"], [2], kv(2), kv(2))
        pool.free("a")
        with pytest.warns(RuntimeWarning):
            with pytest.raises(KeyError) as ei:
                pool.free("a")
        msg = str(ei.value)
        assert "double-free" in msg
        assert "journal tail" in msg

    def test_strict_error_payload(self):
        pool = make_pool()
        pool.alloc("a")
        pool.free("a")
        with pytest.raises(PageSanitizerError) as ei:
            pool.free("a")
        err = ei.value
        assert err.rule in VIOLATIONS
        assert err.events and err.events[-1]["op"] == "free"
        assert err.events[-1]["violations"][0]["rule"] == "double-free"

    def test_invalid_mode_rejected(self):
        with pytest.raises(ValueError, match="warn"):
            make_pool(mode="bogus")

    def test_journal_rollover_still_replays(self, tmp_path):
        # force chunk rollovers well below the event count: the dump
        # must still replay soundly from its snapshot
        pool = PagedKVCacheManager(16, 4, HEADS, DIM,
                                   kv_dtype="float32",
                                   sanitizer="strict", device="cpu")
        pool._san.journal_max = 8
        pool.alloc("a")
        for _ in range(30):
            pool.append_batch(["a"], kv(1), kv(1))
        path = pool.sanitizer.dump(str(tmp_path / "roll.jsonl"))
        res = replay_journal(path)
        assert res.clean
        assert res.sanitizer.lens["a"] == 30
        # and a violation after the rollover is still reconstructed
        pool.free("a")
        with pytest.raises(PageSanitizerError):
            pool.free("a")
        res = replay_journal(
            pool.sanitizer.dump(str(tmp_path / "roll2.jsonl")))
        assert not res.clean and res.error.rule == "double-free"


# ---------------------------------------------------------------------------
# scheduler integration: epoch cross-check + output identity
# ---------------------------------------------------------------------------


class _TinyPagedModel:
    """Minimal BatchScheduler protocol over a real sanitized pool:
    deterministic logits keyed by the fed token id."""

    VOCAB = 13

    def __init__(self, mode, num_pages=64):
        self.caches = [PagedKVCacheManager(
            num_pages, 4, HEADS, DIM, kv_dtype="float32",
            sanitizer=mode, device="cpu")]

    def alloc(self, sid):
        for c in self.caches:
            c.alloc(sid)

    def free(self, sid):
        for c in self.caches:
            c.free(sid)

    def decode_token(self, token_ids, seq_ids):
        for c in self.caches:
            c.append_batch(seq_ids, kv(len(seq_ids)),
                           kv(len(seq_ids)))
            c.attend(torch.zeros(len(seq_ids), HEADS, DIM), seq_ids)
        logits = np.zeros((len(seq_ids), self.VOCAB), "float32")
        for i, t in enumerate(token_ids):
            logits[i, (int(t) * 7 + 3) % self.VOCAB] = 1.0
        return logits


class TestSchedulerIntegration:
    def _serve(self, mode, stride=3):
        from paddle_tpu_torch.inference import BatchScheduler, Request

        old = flag("page_sanitizer_stride")
        set_flags({"page_sanitizer_stride": stride})
        try:
            sched = BatchScheduler(_TinyPagedModel(mode),
                                   max_batch_size=4)
        finally:
            set_flags({"page_sanitizer_stride": old})
        for i in range(3):
            sched.submit(Request(f"r{i}", [2 + i, 5, 7],
                                 max_new_tokens=4))
        done = sched.run_until_complete()
        gen = {r: done[r].generated_ids for r in sorted(done)}
        return gen, sched

    def test_strict_serving_matches_off_and_crosschecks_run(self):
        gen_off, sched_off = self._serve("off")
        gen_strict, sched_strict = self._serve("strict")
        assert gen_strict == gen_off
        stats = sched_strict.page_pool_stats()["sanitizer"]
        assert stats["mode"] == "strict"
        assert stats["events"] > 0
        assert stats["violations"] == 0
        assert stats["crosschecks"] >= 1  # epoch stride fired
        assert "sanitizer" not in sched_off.page_pool_stats()

    def test_epoch_crosscheck_catches_mid_serve_corruption(self):
        from paddle_tpu_torch.inference import BatchScheduler, Request

        old = flag("page_sanitizer_stride")
        set_flags({"page_sanitizer_stride": 2})
        try:
            model = _TinyPagedModel("strict")
            sched = BatchScheduler(model, max_batch_size=2)
        finally:
            set_flags({"page_sanitizer_stride": old})
        sched.submit(Request("r0", [3, 4, 5], max_new_tokens=8))
        sched.step()
        model.caches[0]._free.pop()  # corrupt the pool mid-serve
        with pytest.raises(PageSanitizerError) as ei:
            for _ in range(6):
                sched.step()
        assert ei.value.rule == "capacity-drift"

    def test_strict_assert_ref_invariants_wired(self):
        # strict crosscheck also runs the pool's own invariant check
        pool = make_pool()
        pool.alloc("a")
        pool.append_ragged(["a"], [2], kv(2), kv(2))
        pool.sanitizer_crosscheck()  # healthy: passes both layers


# ---------------------------------------------------------------------------
# fuzzer: deterministic, clean when healthy, teeth when injected
# ---------------------------------------------------------------------------


class TestFuzzer:
    def test_clean_run_is_deterministic_and_violation_free(self):
        a = fuzz_pool(seed=11, steps=80, device="cpu")
        b = fuzz_pool(seed=11, steps=80, device="cpu")
        assert a["violations"] == 0
        assert a == b  # same seed, same event trace
        assert a["events"] > 40
        assert a["by_op"].get("crosscheck", 0) >= 3

    def test_injected_bug_caught_fast(self, tmp_path):
        # one fuzz-level injection in the fast tier (the class-by-
        # class catch+replay coverage above is already fast; the full
        # injection matrix through the fuzzer is @slow below)
        with pytest.raises(PageSanitizerError) as ei:
            fuzz_pool(seed=3, steps=250, inject="cow-write-shared",
                      device="cpu")
        assert ei.value.rule == "cow-write-shared"
        res = replay_journal(ei.value.sanitizer.dump(
            str(tmp_path / "fuzz.jsonl")))
        assert not res.clean and res.error.rule == "cow-write-shared"

    @pytest.mark.parametrize("inject", sorted(INJECTIONS))
    def test_injected_bugs_full_matrix(self, inject, tmp_path):
        with pytest.raises(PageSanitizerError) as ei:
            fuzz_pool(seed=3, steps=300, inject=inject, device="cpu")
        assert ei.value.rule == inject
        res = replay_journal(ei.value.sanitizer.dump(
            str(tmp_path / "fuzz.jsonl")))
        assert not res.clean and res.error.rule == inject

    def test_unknown_injection_rejected(self):
        with pytest.raises(ValueError, match="inject"):
            fuzz_pool(steps=1, inject="made-up", device="cpu")


# ---------------------------------------------------------------------------
# CLI + inventory
# ---------------------------------------------------------------------------


class TestCLI:
    def test_replay_cli(self, tmp_path, capsys):
        pool = make_pool()
        pool.alloc("a")
        pool.free("a")
        with pytest.raises(PageSanitizerError):
            pool.free("a")
        path = pool.sanitizer.dump(str(tmp_path / "cli.jsonl"))
        rc = sanitizer_main(["--replay", path])
        out = capsys.readouterr().out
        assert rc == 1  # violation found
        assert "double-free" in out and "replayed" in out

    def test_replay_cli_clean(self, tmp_path, capsys):
        pool = make_pool()
        pool.alloc("a")
        pool.append_ragged(["a"], [3], kv(3), kv(3))
        path = pool.sanitizer.dump(str(tmp_path / "clean.jsonl"))
        assert sanitizer_main(["--replay", path]) == 0
        assert "replays clean" in capsys.readouterr().out

    def test_fuzz_cli_catches_injection(self, capsys):
        rc = sanitizer_main(["--fuzz", "--steps", "250", "--seed",
                             "3", "--inject", "cow-write-shared",
                             "--device", "cpu"])
        out = capsys.readouterr().out
        assert rc == 0  # caught = success
        assert "CAUGHT" in out

    def test_python_dash_m_entry_point_catches_injection(self):
        # the REAL shipped invocation: under `python -m` this module
        # runs as __main__ with its own copy of PageSanitizerError —
        # the entry point must dispatch to the canonical package
        # module or the except clause never matches (regression:
        # in-process main() calls cannot see this)
        import subprocess
        import sys

        env = dict(os.environ)
        r = subprocess.run(
            [sys.executable, "-m",
             "paddle_tpu_torch.incubate.nn.page_sanitizer", "--fuzz",
             "--steps", "60", "--seed", "3", "--inject",
             "double-free", "--device", "cpu"],
            capture_output=True, text=True, timeout=300, env=env,
            cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
        assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
        assert "CAUGHT" in r.stdout, r.stdout[-2000:]
