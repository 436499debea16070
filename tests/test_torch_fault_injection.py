"""Deterministic fault injection for the port's serving scheduler
(paddle_tpu_torch/incubate/nn/fault_injection.py), by the reference's
own unit tests, over a 1-layer torch paged decoder on the CPU (the
reference's ``TinyPagedDecoder`` of ``tests/test_overload.py``, with a
strict page sanitizer on its pool).

Plan grammar and seeded-plan determinism; per-class absorption on a
live scheduler — forced pool exhaustion (queued work waits, active
decode untouched), preemption storms (victims swap out and restore
bitwise), delayed swap-in (no stall crash, no starvation after the
window), simulated step failure with exponential backoff — each
proven by greedy outputs IDENTICAL to an uninjected run; and the
zero-cost off mode (empty FLAGS_serving_faults constructs nothing).
"""
import pytest
import torch

from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.incubate.nn.fault_injection import (
    FAULT_KINDS,
    FaultInjector,
    parse_fault_plan,
)
from paddle_tpu_torch.incubate.nn import PagedKVCacheManager
from paddle_tpu_torch.inference import BatchScheduler, Request

PAGE = 4
PROMPTS = {f"r{i}": [3 + i, 17, 5, 9, 2 + i, 11, 7, 1 + i]
           for i in range(4)}
HI_PROMPT = [9, 8, 7, 6, 5, 4, 3, 2]
N_NEW = 6


class TinyPagedDecoder(torch.nn.Module):
    """1-layer paged decoder implementing the scheduler's model protocol
    (alloc / free / decode_token / caches and the swap hooks),
    token-per-step, so preemption can land mid-prefill too."""

    def __init__(self, vocab=37, dim=32, heads=2, page_size=PAGE,
                 num_pages=32, sanitizer="strict"):
        super().__init__()
        self.dim, self.heads, self.hd = dim, heads, dim // heads
        self.embed = torch.nn.Embedding(vocab, dim)
        self.qkv = torch.nn.Linear(dim, 3 * dim)
        self.head = torch.nn.Linear(dim, vocab)
        self.caches = [
            PagedKVCacheManager(num_pages, page_size, heads, self.hd,
                                dtype=torch.float32, sanitizer=sanitizer,
                                device="cpu")
        ]

    def alloc(self, sid):
        for c in self.caches:
            c.alloc(sid)

    def free(self, sid):
        for c in self.caches:
            c.free(sid)

    def swap_out(self, sid, space):
        freed = nbytes = 0
        for c in self.caches:
            fp, nb = c.swap_out(sid, space)
            freed += fp
            nbytes += nb
        return freed, nbytes

    def swap_in(self, sid, space):
        return sum(c.swap_in(sid, space) for c in self.caches)

    @torch.inference_mode()
    def decode_token(self, token_ids, seq_ids):
        b = len(seq_ids)
        x = self.embed(torch.tensor(token_ids, dtype=torch.long))
        qkv = self.qkv(x).reshape(b, 3, self.heads, self.hd)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        for bi, sid in enumerate(seq_ids):
            self.caches[0].append(sid, k[bi], v[bi])
        attn = self.caches[0].attend(q, seq_ids)
        return self.head(x + attn.reshape(b, self.dim))


class TestPlanParsing:
    def test_grammar_forms(self):
        plan = parse_fault_plan(
            "exhaust@10+5, preempt_storm@20:2, fail_step@30+3,"
            "delay_swap_in@7")
        assert plan == [
            {"kind": "delay_swap_in", "start": 7, "duration": 1,
             "param": None},
            {"kind": "exhaust", "start": 10, "duration": 5,
             "param": None},
            {"kind": "preempt_storm", "start": 20, "duration": 1,
             "param": 2},
            {"kind": "fail_step", "start": 30, "duration": 3,
             "param": None},
        ]

    def test_empty_and_whitespace_entries_skipped(self):
        assert parse_fault_plan("") == []
        assert parse_fault_plan(" , ,exhaust@1, ") == [
            {"kind": "exhaust", "start": 1, "duration": 1,
             "param": None}]

    @pytest.mark.parametrize("bad", [
        "exhaust",             # no @step
        "meteor@3",            # unknown kind
        "exhaust@0",           # steps count from 1
        "exhaust@2+0",         # zero duration
        "preempt_storm@2:0",   # zero param
        "exhaust@x",           # non-integer
    ])
    def test_rejects_malformed(self, bad):
        with pytest.raises(ValueError):
            parse_fault_plan(bad)

    def test_kind_inventory_is_stable(self):
        assert [k for k, _ in FAULT_KINDS] == [
            "exhaust", "preempt_storm", "delay_swap_in", "fail_step"]


class TestDeterminism:
    def test_seeded_random_plan_replays(self):
        a = FaultInjector.random(seed=5, steps=100, n_faults=6)
        b = FaultInjector.random(seed=5, steps=100, n_faults=6)
        assert a.plan == b.plan
        c = FaultInjector.random(seed=6, steps=100, n_faults=6)
        assert a.plan != c.plan

    def test_from_flag_empty_is_none(self):
        assert FaultInjector.from_flag() is None
        set_flags({"serving_faults": "exhaust@2+1"})
        try:
            inj = FaultInjector.from_flag()
            assert inj is not None
            assert inj.plan[0]["kind"] == "exhaust"
        finally:
            set_flags({"serving_faults": ""})

    def test_consultation_log_and_summary(self):
        inj = FaultInjector("exhaust@2+2,preempt_storm@3:2")
        assert not inj.pool_exhausted(1)
        assert inj.pool_exhausted(2)
        assert inj.pool_exhausted(3)
        assert not inj.pool_exhausted(4)  # window [2, 4)
        assert inj.forced_preemptions(3) == 2
        assert inj.forced_preemptions(3) == 0  # storms fire ONCE
        s = inj.summary()
        assert s["fired"] == {"exhaust": 2, "preempt_storm": 1}
        assert [e["kind"] for e in inj.events()] == [
            "exhaust", "exhaust", "preempt_storm"]


# -- live-scheduler absorption ----------------------------------------------


def _sched(faults=None, num_pages=24, **kw):
    torch.manual_seed(11)
    model = TinyPagedDecoder(num_pages=num_pages)
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("preempt", True)
    kw.setdefault("swap_bytes", 64 << 20)
    inj = FaultInjector(faults) if faults is not None else None
    return model, BatchScheduler(model, fault_injector=inj, **kw)


def _run_all(sched, priorities=None):
    pr = priorities or {}
    for rid, p in PROMPTS.items():
        sched.submit(Request(rid, list(p), max_new_tokens=N_NEW,
                             priority=pr.get(rid, 0)))
    sched.submit(Request("hi", list(HI_PROMPT), max_new_tokens=N_NEW,
                         priority=pr.get("hi", 0)))
    done = sched.run_until_complete(max_steps=4000)
    return {k: list(v.generated_ids) for k, v in done.items()}


_CLEAN = None


def _clean_run():
    global _CLEAN
    if _CLEAN is None:
        _, sched = _sched(None)
        _CLEAN = _run_all(sched)
    return _CLEAN


class TestFaultAbsorption:
    def test_default_flags_cost_no_injector(self):
        _, sched = _sched(None)
        assert sched._faults is None

    def test_exhaust_blocks_admission_not_decode(self):
        _, sched = _sched("exhaust@2+3", max_batch_size=2)
        sched.submit(Request("a", [1, 2, 3], max_new_tokens=4))
        sched.step()  # step 1: a admitted before the window
        sched.submit(Request("b", [4, 5], max_new_tokens=2))
        for expect_step in (2, 3, 4):
            ev = sched.step()
            assert ev["faulted"] == "exhaust"
            assert ev["admitted"] == 0  # b must wait
            assert ev["advanced"] == 1  # a keeps decoding untouched
        ev = sched.step()  # window over
        assert "faulted" not in ev
        assert ev["admitted"] == 1
        done = sched.run_until_complete()
        assert set(done) == {"a", "b"}

    def test_preempt_storm_restores_bitwise(self):
        _, sched = _sched("preempt_storm@6:2")
        got = _run_all(sched)
        st = sched.page_pool_stats()
        assert st["swap"]["swapped_out_records"] >= 1
        assert st["swap"]["records"] == 0
        assert got == _clean_run()
        assert st["free_pages"] == st["total_pages"]

    def test_delay_swap_in_window_then_resume(self):
        # the delay window covers the storm step itself — otherwise
        # the same step's admission pass restores the victims at once
        _, sched = _sched("preempt_storm@4:2,delay_swap_in@4+4")
        for rid, p in PROMPTS.items():
            sched.submit(Request(rid, list(p), max_new_tokens=N_NEW))
        for _ in range(4):
            sched.step()
        assert sched.num_swapped >= 1  # the storm hit, victims frozen
        for _ in range(3):  # steps 5-7: the rest of the freeze
            before = sched.num_swapped
            ev = sched.step()
            if before:
                assert ev["faulted"] == "delay_swap_in"
                assert sched.num_swapped == before  # frozen out
        done = sched.run_until_complete(max_steps=4000)
        # nobody starved once the window lifted
        assert all(done[r].finished for r in PROMPTS)
        clean = _clean_run()
        for rid in PROMPTS:
            assert done[rid].generated_ids == clean[rid], rid

    def test_storm_inside_delay_window_notes_both(self):
        """Two faults on one step must BOTH survive onto the event
        ("+"-joined), not last-writer-wins: a preempt storm landing
        inside a delay_swap_in window is exactly the shipped bench
        plan's shape."""
        _, sched = _sched("preempt_storm@3:1,delay_swap_in@3+2")
        sched.submit(Request("a", [1, 2, 3], max_new_tokens=6))
        sched.step()
        sched.step()
        ev = sched.step()  # storm swaps "a" out; swap-in is delayed
        assert ev["faulted"] == "preempt_storm+delay_swap_in"
        assert sched.num_swapped == 1
        done = sched.run_until_complete()
        assert done["a"].finished

    def test_fail_step_retry_backoff_schedule(self):
        _, sched = _sched("fail_step@2+3")
        sched.submit(Request("a", [1, 2, 3], max_new_tokens=4))
        marks = []
        for _ in range(6):
            marks.append(sched.step().get("faulted"))
        # step 1 runs; 2 fails (retry next); 3 fails (skip 1);
        # 4 backs off; 5 fails? no — window is [2, 5) so 5 runs
        assert marks == [None, "fail_step", "fail_step", "backoff",
                         None, None]
        done = sched.run_until_complete()
        assert done["a"].finished

    def test_backoff_is_exponential_and_capped(self):
        inj = FaultInjector("fail_step@1+40")
        _, sched = _sched(None)
        sched._faults = inj
        sched.submit(Request("a", [1, 2], max_new_tokens=2))
        skips = []
        run = 0
        prev_fail = None
        for step in range(1, 41):
            ev = sched.step()
            if ev.get("faulted") == "fail_step":
                if prev_fail is not None:
                    skips.append(step - prev_fail - 1)
                prev_fail = step
        # consecutive failures: gaps grow 0, 1, 3, 7 then cap at 8
        assert skips[:4] == [0, 1, 3, 7]
        assert all(s == 8 for s in skips[4:])

    def test_combined_plan_greedy_identical(self):
        _, sched = _sched(
            "exhaust@3+2,preempt_storm@7:2,delay_swap_in@8+3,"
            "fail_step@14+2")
        got = _run_all(sched,
                       priorities={"r0": 0, "r1": 0, "r2": 1,
                                   "r3": 1, "hi": 2})
        assert got == _clean_run()
        assert sched._faults.counts  # something actually fired
        st = sched.page_pool_stats()
        assert st["free_pages"] == st["total_pages"]

    def test_seeded_random_plan_absorbed(self):
        plan = FaultInjector.random(seed=3, steps=60, n_faults=5)
        fired_kinds = [f["kind"] for f in plan.plan]
        _, sched = _sched(None)
        sched._faults = plan
        got = _run_all(sched)
        assert got == _clean_run()
        assert set(sched._faults.counts) <= set(fired_kinds)
