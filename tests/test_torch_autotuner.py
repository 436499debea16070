"""The port's capacity autotuner (``framework/autotuner.py``), on the CPU.

The reference's ``tests/test_autotuner.py`` cases run against the port:
static scoring against the budgets (infeasible candidates are never
deployed), hill-climb convergence on a synthetic surface with hysteresis,
watchdog quarantine, the artifact round trip, and the step-boundary-only
apply seam (scheduler and async engine; the scheduler half over the
1-layer torch paged decoder of ``tests/test_torch_fault_injection.py``).

Against the JAX package (exact equality throughout, floats included:
both modules do the same float64 arithmetic in the same order):
hypothesis-drawn inputs give the same ``parse_space``,
``enumerate_candidates``, ``static_score``, ``check_feasible``,
``live_score`` and ``measure_from_snapshot``; and an ``Autotuner`` fed
the same measurement sequence makes the same decisions (deployments,
state, incumbent, switches, quarantines) and writes the same artifact
JSON.
"""
import asyncio
import json
import os

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from paddle_tpu.framework import autotuner as jat
from paddle_tpu.framework.flags import flag as jax_flag
from paddle_tpu.framework.flags import set_flags as jax_set_flags

from paddle_tpu_torch.framework import autotuner as at
from paddle_tpu_torch.framework import ops_server, telemetry
from paddle_tpu_torch.framework.flags import flag, set_flags
from paddle_tpu_torch.inference import BatchScheduler, Request, ServingEngine

from test_torch_fault_injection import N_NEW, PROMPTS, TinyPagedDecoder

BAD = at.CandidateConfig(256, (512,))
GOOD = at.CandidateConfig(16, (8, 16, 32, 64))
MID = at.CandidateConfig(64, (16, 64, 256))


def profile(**kw):
    kw.setdefault("hbm_per_token", 1e6)
    kw.setdefault("comm_per_token", 1e3)
    kw.setdefault("wall_per_token_s", 1e-4)
    kw.setdefault("compile_cost_s", 0.05)
    return at.WorkloadProfile([48, 48, 4, 4], **kw)


@pytest.fixture
def capacity_flags():
    """Snapshot + restore the capacity knobs a test may mutate
    through the apply seam."""
    saved = {k: flag(k) for k in at.CAPACITY_KNOBS}
    yield saved
    set_flags(saved)


class TestSearchSpace:
    def test_default_enumeration_covers_product(self):
        cands = at.enumerate_candidates()
        n = 1
        for alts in at.DEFAULT_SPACE.values():
            n *= len(alts)
        assert len(cands) == n
        assert len({c.key() for c in cands}) == n

    def test_parse_space_override_and_defaults(self):
        space = at.parse_space(
            "chunk=16|32;buckets=8,16|8,16,32;dtype=off|int8")
        assert space["chunk"] == (16, 32)
        assert space["buckets"] == ("8,16", "8,16,32")
        assert space["dtype"] == ("off", "int8")
        # knobs absent from the spec keep the built-in alternatives
        assert space["swap"] == at.DEFAULT_SPACE["swap"]
        cands = at.enumerate_candidates(space)
        assert len(cands) == 2 * 2 * 2 * len(space["swap"])

    def test_parse_space_rejects_unknown_knob(self):
        with pytest.raises(ValueError):
            at.parse_space("nope=1|2")

    def test_candidate_key_and_flags_round_trip(self):
        c = at.CandidateConfig(32, "16, 8", 0, "int8", "0.7:0.95")
        assert c.serving_buckets == (8, 16)
        c2 = at.CandidateConfig.from_dict(c.to_dict())
        assert c2 == c and c2.flags() == c.flags()


class TestStaticScoring:
    def test_coarse_single_bucket_pays_padding_tax(self):
        w = profile(compile_cost_s=0.0)   # isolate the padding tax
        # one 512 bucket pads the 4-token decode steps to 512
        assert at.static_score(BAD, w) > 3 * at.static_score(GOOD, w)

    def test_wire_quantization_lowers_score_when_comm_priced(self):
        w = profile(comm_s_per_byte=1e-6)
        q = at.CandidateConfig(16, (8, 16, 32, 64),
                               collective_dtype="int8")
        assert at.static_score(q, w) < at.static_score(GOOD, w)

    def test_recompile_tax_scales_with_reachable_buckets(self):
        w = at.WorkloadProfile([4], wall_per_token_s=0.0,
                               compile_cost_s=1.0)
        one = at.CandidateConfig(16, (8,))
        # only the buckets the workload can actually reach count
        many = at.CandidateConfig(16, (4, 8))
        assert at.static_score(many, w) == at.static_score(one, w)

    def test_feasibility_hbm_and_comm_budgets(self):
        w = profile()
        ok, why = at.check_feasible(BAD, w, hbm_budget=int(3e8),
                                    comm_budget=0)
        assert not ok and "hbm-over-budget" in why
        ok, why = at.check_feasible(GOOD, w, hbm_budget=int(3e8),
                                    comm_budget=0)
        assert ok and why is None
        ok, why = at.check_feasible(GOOD, w, hbm_budget=0,
                                    comm_budget=1)
        assert not ok and "comm-over-budget" in why
        # quantize-on-the-wire can rescue a comm-tight candidate
        q = at.CandidateConfig(16, (8, 16, 32, 64),
                               collective_dtype="int8")
        # the biggest compiled program is the chunk-capped bucket
        # (16 tokens here), so budget just under its fp wire bytes
        budget = int(16 * 1e3 * 0.5)
        assert not at.check_feasible(GOOD, w, 0, budget)[0]
        assert at.check_feasible(q, w, 0, budget)[0]

    def test_infeasible_candidates_never_deployed(self):
        w = profile()
        deployed = []
        tn = at.Autotuner(candidates=[BAD, GOOD, MID], profile=w,
                          apply_fn=lambda f: deployed.append(f) or f,
                          hbm_budget=int(3e8), eval_windows=1,
                          min_improve=0.05)
        assert [e["candidate"] for e in tn.rejected] == [BAD]
        tn.start()
        for _ in range(10):
            tn.observe(at.Measurement(goodput=0.9, step_p50_s=0.01))
        assert tn.state == "converged"
        chunks = {f["prefill_chunk_tokens"] for f in deployed}
        assert BAD.prefill_chunk_tokens not in chunks

    def test_empty_frontier_raises(self):
        with pytest.raises(ValueError, match="feasible"):
            at.Autotuner(candidates=[BAD], profile=profile(),
                         hbm_budget=1)


def synthetic_surface(scores):
    """Deploy-aware measurement source: the live p50 of the deployed
    candidate comes from the surface dict."""
    state = {}

    def apply_fn(flags_dict):
        state["chunk"] = flags_dict["prefill_chunk_tokens"]
        return flags_dict

    def measure(noise=0.0):
        return at.Measurement(goodput=0.9,
                              step_p50_s=scores[state["chunk"]]
                              + noise)

    return apply_fn, measure


class TestHillClimb:
    def test_converges_to_best_live_candidate(self):
        # static order puts GOOD first, but the synthetic live
        # surface says MID is actually fastest — the climb must
        # discover that and adopt MID
        surface = {GOOD.prefill_chunk_tokens: 0.030,
                   MID.prefill_chunk_tokens: 0.010,
                   BAD.prefill_chunk_tokens: 0.050}
        apply_fn, measure = synthetic_surface(surface)
        tn = at.Autotuner(candidates=[GOOD, MID, BAD],
                          profile=profile(), apply_fn=apply_fn,
                          eval_windows=3, min_improve=0.05)
        tn.start()
        for _ in range(20):
            if tn.state == "converged":
                break
            tn.observe(measure())
        assert tn.state == "converged"
        assert tn.best()["candidate"] == MID
        assert tn.switches >= 1

    def test_one_noisy_window_cannot_thrash(self):
        # the challenger gets ONE lucky outlier window; the median
        # over eval_windows drowns it and the incumbent stays
        surface = {GOOD.prefill_chunk_tokens: 0.010,
                   MID.prefill_chunk_tokens: 0.030,
                   BAD.prefill_chunk_tokens: 0.050}
        apply_fn, measure = synthetic_surface(surface)
        tn = at.Autotuner(candidates=[GOOD, MID],
                          profile=profile(), apply_fn=apply_fn,
                          eval_windows=3, min_improve=0.05)
        tn.start()
        for _ in range(3):          # incumbent = GOOD
            tn.observe(measure())
        assert tn.incumbent["candidate"] == GOOD
        assert tn.current["candidate"] == MID
        tn.observe(measure(noise=-0.028))   # lucky outlier: 0.002
        for _ in range(2):
            tn.observe(measure())
        assert tn.best()["candidate"] == GOOD
        assert tn.switches == 0

    def test_dead_band_blocks_marginal_challenger(self):
        # challenger is 2% better — inside the 5% dead band, so the
        # tuner must NOT churn the config for a marginal win
        surface = {GOOD.prefill_chunk_tokens: 0.0100,
                   MID.prefill_chunk_tokens: 0.0098}
        apply_fn, measure = synthetic_surface(surface)
        tn = at.Autotuner(candidates=[GOOD, MID],
                          profile=profile(), apply_fn=apply_fn,
                          eval_windows=2, min_improve=0.05)
        tn.start()
        for _ in range(8):
            if tn.state == "converged":
                break
            tn.observe(measure())
        assert tn.best()["candidate"] == GOOD
        assert tn.switches == 0

    def test_no_signal_windows_are_skipped_not_counted(self):
        apply_fn, measure = synthetic_surface(
            {GOOD.prefill_chunk_tokens: 0.01})
        tn = at.Autotuner(candidates=[GOOD], profile=profile(),
                          apply_fn=apply_fn, eval_windows=2)
        tn.start()
        tn.observe(at.Measurement())            # all-None: no signal
        tn.observe(at.Measurement(drift_ratio=0.1))
        assert tn.current["live_scores"] == []
        tn.observe(measure())
        tn.observe(measure())
        assert tn.current["live_score"] is not None


class TestWatchdogQuarantine:
    def test_trip_quarantines_and_reverts(self):
        surface = {GOOD.prefill_chunk_tokens: 0.010,
                   MID.prefill_chunk_tokens: 0.005,
                   BAD.prefill_chunk_tokens: 0.050}
        apply_fn, measure = synthetic_surface(surface)
        tn = at.Autotuner(candidates=[GOOD, MID, BAD],
                          profile=profile(), apply_fn=apply_fn,
                          eval_windows=2, min_improve=0.05)
        tn.start()
        for _ in range(2):          # incumbent = GOOD, probe MID
            tn.observe(measure())
        assert tn.current["candidate"] == MID
        # MID looks fast but storms the compiler: hard negative
        tn.observe(at.Measurement(
            goodput=0.9, step_p50_s=0.005,
            watchdog_events=("recompile-storm",)))
        e = tn.table[MID.key()]
        assert e["quarantined"]
        assert "recompile-storm" in e["quarantine_reason"]
        assert tn.quarantined == 1
        assert tn.current["candidate"] != MID
        # drive to convergence: the quarantined candidate never wins
        # and is never redeployed
        for _ in range(10):
            if tn.state == "converged":
                break
            tn.observe(measure())
        assert tn.best()["candidate"] == GOOD

    def test_benign_watchdog_classes_do_not_quarantine(self):
        apply_fn, measure = synthetic_surface(
            {GOOD.prefill_chunk_tokens: 0.01})
        tn = at.Autotuner(candidates=[GOOD], profile=profile(),
                          apply_fn=apply_fn, eval_windows=2)
        tn.start()
        tn.observe(at.Measurement(
            goodput=0.9, step_p50_s=0.01,
            watchdog_events=("decode-stall",)))
        assert not tn.table[GOOD.key()]["quarantined"]

    def test_all_quarantined_raises_loudly(self):
        apply_fn, _ = synthetic_surface(
            {GOOD.prefill_chunk_tokens: 0.01})
        tn = at.Autotuner(candidates=[GOOD], profile=profile(),
                          apply_fn=apply_fn, eval_windows=1)
        tn.start()
        with pytest.raises(RuntimeError, match="quarantined"):
            tn.observe(at.Measurement(
                goodput=0.5, step_p50_s=0.5,
                watchdog_events=("plan-drift",)))


class TestMeasurement:
    def test_measure_from_snapshot_happy_path(self):
        snap = {"serving": {"goodput": 0.8,
                            "step_wall_s": {"p50": 0.02}},
                "ledger": {"drift_ratio.attend": 0.3,
                           "drift_ratio.mlp": 1.7}}
        m = at.measure_from_snapshot(snap)
        assert m.goodput == 0.8 and m.step_p50_s == 0.02
        assert m.drift_ratio == 1.7
        assert at.live_score(m) is not None

    def test_partial_and_malformed_snapshots_degrade_to_no_signal(
            self):
        for snap in ({}, None,
                     {"serving": None},
                     {"serving": {"goodput": "nan?",
                                  "step_wall_s": None}},
                     {"serving": {"step_wall_s": {"p50": None}},
                      "ledger": None},
                     {"ledger": {"drift_ratio.x": None,
                                 "drift_ratio.y": "bogus"}}):
            m = at.measure_from_snapshot(snap)
            assert not m.has_signal()
            assert at.live_score(m) is None

    def test_zero_wall_p50_is_no_signal(self):
        m = at.measure_from_snapshot(
            {"serving": {"step_wall_s": {"p50": 0.0}}})
        assert m.step_p50_s is None


class TestArtifact:
    def test_round_trip_and_reapply(self, tmp_path, capacity_flags):
        apply_fn, measure = synthetic_surface(
            {GOOD.prefill_chunk_tokens: 0.01,
             MID.prefill_chunk_tokens: 0.03})
        tn = at.Autotuner(candidates=[GOOD, MID], profile=profile(),
                          apply_fn=apply_fn, eval_windows=1)
        tn.start()
        for _ in range(4):
            tn.observe(measure())
        path = str(tmp_path / "TUNED_CONFIG_LAST.json")
        assert tn.write_artifact(path) == path
        art = at.load_artifact(path)
        assert art["kind"] == "paddle_tpu.tuned_config"
        assert art["flags"] == tn.best()["candidate"].flags()
        assert any(r["winner"] for r in art["table"])
        # plan-vs-chosen rows cover every capacity knob
        assert {r["knob"] for r in art["plan_vs_chosen"]} \
            == set(at.CAPACITY_KNOBS)
        # re-apply through the seam: the flags land verbatim
        applied = at.apply_artifact(path)
        assert applied == art["flags"]
        for k, v in art["flags"].items():
            assert flag(k) == v

    def test_load_rejects_foreign_json(self, tmp_path):
        p = tmp_path / "other.json"
        p.write_text(json.dumps({"kind": "something_else"}))
        with pytest.raises(ValueError, match="tuned-config"):
            at.load_artifact(str(p))

    def test_load_rejects_corrupt_chosen_config(self, tmp_path):
        apply_fn, _ = synthetic_surface(
            {GOOD.prefill_chunk_tokens: 0.01})
        tn = at.Autotuner(candidates=[GOOD], profile=profile(),
                          apply_fn=apply_fn)
        path = str(tmp_path / "t.json")
        tn.write_artifact(path)
        art = json.load(open(path))
        art["chosen"]["collective_dtype"] = "float128"
        open(path, "w").write(json.dumps(art))
        with pytest.raises(ValueError):
            at.load_artifact(str(path))

    def test_flag_configured_artifact_path(self, tmp_path,
                                           capacity_flags):
        apply_fn, _ = synthetic_surface(
            {GOOD.prefill_chunk_tokens: 0.01})
        tn = at.Autotuner(candidates=[GOOD], profile=profile(),
                          apply_fn=apply_fn)
        assert tn.write_artifact() is None  # flag empty -> no write
        path = str(tmp_path / "flagged.json")
        set_flags({"autotune_artifact": path})
        try:
            assert tn.write_artifact() == path
            assert os.path.exists(path)
        finally:
            set_flags({"autotune_artifact": ""})


def _sched(**kw):
    torch.manual_seed(11)
    model = TinyPagedDecoder(num_pages=24)
    kw.setdefault("max_batch_size", 4)
    return model, BatchScheduler(model, **kw)


class TestApplySeam:
    def test_scheduler_apply_between_steps(self, capacity_flags):
        _, sched = _sched()
        before = sched.prefill_chunk_tokens
        applied = sched.apply_capacity_config(
            {"prefill_chunk_tokens": before * 2,
             "serving_buckets": "4,8,64",
             "unrelated": 1})
        assert sched.prefill_chunk_tokens == before * 2
        assert sched.serving_buckets == (4, 8, 64)
        assert applied == {"prefill_chunk_tokens": before * 2,
                           "serving_buckets": "4,8,64"}
        # idempotent re-apply reports nothing changed
        assert sched.apply_capacity_config(
            {"serving_buckets": "64,8,4"}) == {}

    def test_mid_step_application_refused(self, capacity_flags):
        model, sched = _sched()
        rid, prompt = next(iter(PROMPTS.items()))
        sched.submit(Request(rid, list(prompt),
                             max_new_tokens=N_NEW))
        seen = []
        inner = model.decode_token

        def hooked(token_ids, seq_ids):
            with pytest.raises(RuntimeError,
                               match="step boundar"):
                sched.apply_capacity_config(
                    {"prefill_chunk_tokens": 99})
            seen.append(1)
            return inner(token_ids, seq_ids)

        model.decode_token = hooked
        sched.step()
        assert seen  # the guard actually fired mid-step
        model.decode_token = inner
        # ... and the knob did NOT change
        assert sched.prefill_chunk_tokens != 99
        # boundary apply still works afterwards
        sched.apply_capacity_config({"prefill_chunk_tokens": 99})
        assert sched.prefill_chunk_tokens == 99
        sched.run_until_complete(max_steps=500)

    def test_swap_budget_never_shrinks_below_resident(
            self, capacity_flags):
        _, sched = _sched(preempt=True, swap_bytes=64 << 20)
        assert sched.swap_space is not None
        sched.apply_capacity_config({"serving_swap_bytes": 1 << 20})
        assert sched.swap_space.capacity_bytes == 1 << 20

    def test_engine_apply_config_on_pump_thread(self,
                                                capacity_flags):
        model, sched = _sched()

        async def main():
            async with ServingEngine(sched) as eng:
                streams = [await eng.submit(
                    Request(rid, list(p), max_new_tokens=N_NEW))
                    for rid, p in PROMPTS.items()]
                applied = await eng.apply_config(
                    {"prefill_chunk_tokens": 48,
                     "engine_goodput_low": 0.5,
                     "engine_goodput_high": 0.8})
                out = {s.req_id: await s.tokens() for s in streams}
                return applied, eng._gp_low, eng._gp_high, out

        applied, lo, hi, out = asyncio.run(main())
        assert applied["prefill_chunk_tokens"] == 48
        assert sched.prefill_chunk_tokens == 48
        assert (lo, hi) == (0.5, 0.8)
        assert flag("prefill_chunk_tokens") == 48
        assert all(len(v) for v in out.values())

    def test_apply_config_filters_to_capacity_knobs(
            self, capacity_flags):
        before = flag("serving_max_queue")
        applied = at.apply_config({"serving_max_queue": 7,
                                   "prefill_chunk_tokens": 32})
        assert applied == {"prefill_chunk_tokens": 32}
        assert flag("serving_max_queue") == before


class TestOpsPages:
    def test_tunez_and_planz_render_plan_vs_chosen(
            self, capacity_flags):
        import urllib.request

        set_flags({"telemetry": "metrics"})
        telemetry.reset()
        try:
            apply_fn, measure = synthetic_surface(
                {GOOD.prefill_chunk_tokens: 0.01,
                 MID.prefill_chunk_tokens: 0.03})
            tn = at.Autotuner(candidates=[GOOD, MID],
                              profile=profile(), apply_fn=apply_fn,
                              eval_windows=1)
            tn.start()
            for _ in range(4):
                tn.observe(measure())
            srv = ops_server.OpsServer(port=0)
            try:
                srv.add_tuner_provider("tuner", tn._tunez_info)

                def get(page):
                    with urllib.request.urlopen(
                            srv.url + page, timeout=10) as r:
                        return r.read().decode()

                tz = get("/tunez")
                assert GOOD.key() in tz and MID.key() in tz
                assert "plan-vs-chosen" in tz
                assert "state=converged" in tz
                pz = get("/planz")
                assert "plan-vs-chosen" in pz
                assert "prefill_chunk_tokens" in pz
                idx = get("/")
                assert "/tunez" in idx
            finally:
                srv.close()
        finally:
            set_flags({"telemetry": "off"})
            telemetry.reset()

    def test_autotune_metrics_published(self, capacity_flags):
        set_flags({"telemetry": "metrics"})
        telemetry.reset()
        try:
            reg = telemetry.registry()
            apply_fn, measure = synthetic_surface(
                {GOOD.prefill_chunk_tokens: 0.01})
            tn = at.Autotuner(candidates=[GOOD], profile=profile(),
                              apply_fn=apply_fn, eval_windows=1)
            tn.start()
            tn.observe(measure())
            snap = reg.snapshot().get("autotune", {})
            assert snap.get("windows") == 1
            assert "state" in snap and "best_score" in snap
        finally:
            set_flags({"telemetry": "off"})
            telemetry.reset()



# ------------------------------------------------ against the JAX package
_LADDERS = st.lists(st.integers(1, 600), min_size=1, max_size=5,
                    unique=True).map(
    lambda xs: ",".join(str(x) for x in sorted(xs)))
_BANDS = st.tuples(st.integers(0, 8), st.integers(1, 9)).filter(
    lambda t: t[0] < t[1]).map(lambda t: "%g:%g" % (t[0] / 10, t[1] / 10))
_KNOB_ALTS = {
    "chunk": st.lists(st.integers(1, 1024), min_size=1, max_size=3,
                      unique=True).map(lambda v: "|".join(map(str, v))),
    "buckets": st.lists(_LADDERS, min_size=1, max_size=3,
                        unique=True).map("|".join),
    "swap": st.lists(st.sampled_from([0, 1 << 20, 256 << 20]),
                     min_size=1, max_size=2,
                     unique=True).map(lambda v: "|".join(map(str, v))),
    "dtype": st.lists(st.sampled_from(["off", "int8", "fp8"]),
                      min_size=1, max_size=3, unique=True).map("|".join),
    "band": st.lists(_BANDS, min_size=1, max_size=2,
                     unique=True).map("|".join),
}
SPECS = st.dictionaries(st.sampled_from(sorted(_KNOB_ALTS)),
                        st.just(None), max_size=5).flatmap(
    lambda d: st.fixed_dictionaries(
        {k: _KNOB_ALTS[k] for k in d})).map(
    lambda d: ";".join("%s=%s" % kv for kv in d.items()))

PROFILES = st.fixed_dictionaries({
    "packed_tokens": st.lists(st.integers(0, 2000), min_size=1,
                              max_size=6),
    "hbm_fixed_bytes": st.floats(0, 8e10),
    "hbm_per_token": st.floats(0, 1e7),
    "comm_per_token": st.floats(0, 1e5),
    "wall_per_token_s": st.floats(0, 1e-2),
    "comm_s_per_byte": st.floats(0, 1e-6),
    "compile_cost_s": st.floats(0, 5.0),
    "amortize_steps": st.integers(1, 400),
})

_OPT = st.one_of(st.none(), st.floats(-1.0, 5.0))
MEASURES = st.fixed_dictionaries({
    "goodput": _OPT, "step_p50_s": _OPT, "drift_ratio": _OPT,
    "decode_tok_s": st.one_of(st.none(), st.floats(0.0, 1e5)),
    "watchdog_events": st.lists(st.sampled_from(
        ["decode-stall", "plan-drift", "recompile-storm",
         "pool-pressure"]), max_size=2).map(tuple)})

_JUNK = st.one_of(st.none(), st.floats(-1, 2), st.text(max_size=3),
                  st.integers(-2, 2))
SNAPSHOTS = st.one_of(st.none(), st.fixed_dictionaries({
    "serving": st.one_of(st.none(), st.fixed_dictionaries({
        "goodput": _JUNK,
        "step_wall_s": st.one_of(_JUNK, st.fixed_dictionaries(
            {"p50": _JUNK}))})),
    "ledger": st.one_of(st.none(), st.dictionaries(
        st.sampled_from(["drift_ratio.a", "drift_ratio.b", "other"]),
        _JUNK, max_size=3))}))

_HYP = settings(max_examples=60, deadline=None, database=None,
                suppress_health_check=[HealthCheck.too_slow])


def _outcome(fn, *args):
    """``fn(*args)``'s value, or the type of what it raised: the two
    packages must agree on both."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 - compared, not swallowed
        return "raised", type(e).__name__


def _cands(mod, spec):
    return mod.enumerate_candidates(mod.parse_space(spec))


@_HYP
@given(SPECS)
def test_parse_space_and_enumeration_parity(spec):
    assert at.parse_space(spec) == jat.parse_space(spec)
    assert [c.key() for c in _cands(at, spec)] == \
        [c.key() for c in _cands(jat, spec)]
    assert [c.flags() for c in _cands(at, spec)] == \
        [c.flags() for c in _cands(jat, spec)]


@_HYP
@given(SPECS, PROFILES, st.integers(0, int(3e10)),
       st.integers(0, int(2e8)))
def test_static_score_and_feasibility_parity(spec, prof, hbm, comm):
    tp, jp = at.WorkloadProfile(**prof), jat.WorkloadProfile(**prof)
    assert tp.to_dict() == jp.to_dict()
    for tc, jc in zip(_cands(at, spec), _cands(jat, spec)):
        assert at.static_score(tc, tp) == jat.static_score(jc, jp)
        assert at.check_feasible(tc, tp, hbm, comm) == \
            jat.check_feasible(jc, jp, hbm, comm)


@_HYP
@given(MEASURES)
def test_live_score_parity(m):
    # both raise TypeError on a window whose only signal is a zero
    # decode rate (the goodput-alone branch divides by max(None, 0.05))
    assert _outcome(at.live_score, at.Measurement(**m)) == \
        _outcome(jat.live_score, jat.Measurement(**m))


@_HYP
@given(SNAPSHOTS)
def test_measure_from_snapshot_parity(snap):
    tm = at.measure_from_snapshot(snap)
    jm = jat.measure_from_snapshot(snap)
    assert tm.to_dict() == jm.to_dict()
    assert _outcome(at.live_score, tm) == _outcome(jat.live_score, jm)


def test_profile_from_plan_is_duck_typed_alike():
    plan = {"hbm_peak_bytes": 6.4e10, "comm_bytes_total": 0}

    class Plan:
        hbm_peak_bytes = 6.4e10
        comm_bytes_total = "n/a"

    for p in (plan, Plan(), None):
        assert at.WorkloadProfile.from_plan(p, 256, [248, 8]).to_dict() \
            == jat.WorkloadProfile.from_plan(p, 256, [248, 8]).to_dict()


@pytest.fixture
def both_flags():
    keys = at.CAPACITY_KNOBS + ("autotune_eval_windows",
                                "autotune_min_improve")
    saved = ({k: flag(k) for k in keys}, {k: jax_flag(k) for k in keys})
    yield
    set_flags(saved[0])
    jax_set_flags(saved[1])


SURFACE = {16: [0.030, 0.029, 0.041], 64: [0.012, 0.011, 0.013],
           128: [0.020, 0.019, 0.018], 256: [0.050, 0.052, 0.049],
           32: [0.0118, 0.0115, 0.0119]}


def _drive(mod, trip_at=None):
    """An Autotuner of ``mod`` over a 5-candidate space fed a fixed
    measurement sequence (the deployed chunk picks the next window's
    p50); a recompile storm lands on ``trip_at``-th window."""
    deployed = []

    def apply_fn(f):
        deployed.append(dict(f))
        return f

    cands = mod.enumerate_candidates(mod.parse_space(
        "chunk=16|32|64|128|256;buckets=16,64,256;swap=0;dtype=off"))
    prof = mod.WorkloadProfile([48, 200, 4, 4, 120],
                               hbm_per_token=1e6, comm_per_token=1e3,
                               wall_per_token_s=1e-4,
                               compile_cost_s=0.05)
    tn = mod.Autotuner(candidates=cands, profile=prof, apply_fn=apply_fn,
                       hbm_budget=int(4e8), eval_windows=3,
                       min_improve=0.05)
    log = [tn.start()]
    seen = {}
    for w in range(40):
        if tn.state == "converged":
            break
        chunk = deployed[-1]["prefill_chunk_tokens"]
        i = seen.get(chunk, 0)
        seen[chunk] = i + 1
        ev = ("recompile-storm",) if w == trip_at else ()
        got = tn.observe(mod.Measurement(
            goodput=0.9, step_p50_s=SURFACE[chunk][i % 3],
            watchdog_events=ev))
        log.append((got.key(), tn.state, tn.switches, tn.quarantined,
                    None if tn.incumbent is None
                    else tn.incumbent["candidate"].key()))
    return tn, deployed, log


@pytest.mark.parametrize("trip_at", [None, 4])
def test_autotuner_decisions_and_artifact_equal_the_jax_one(
        both_flags, trip_at):
    tt, tdep, tlog = _drive(at, trip_at)
    jt, jdep, jlog = _drive(jat, trip_at)
    assert tlog == jlog
    assert tdep == jdep
    assert tt.state == jt.state == "converged"
    assert [e["candidate"].key() for e in tt.rejected] == \
        [e["candidate"].key() for e in jt.rejected]
    assert json.dumps(tt.artifact(), sort_keys=True) == \
        json.dumps(jt.artifact(), sort_keys=True)
    if trip_at is not None:
        assert tt.quarantined == 1


def test_artifacts_cross_apply(tmp_path, both_flags):
    """Each package's artifact file loads and re-applies in the other."""
    tt, _, _ = _drive(at)
    jt, _, _ = _drive(jat)
    tp, jp = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tt.write_artifact(tp)
    jt.write_artifact(jp)
    assert open(tp).read() == open(jp).read()
    assert at.apply_artifact(jp) == jat.apply_artifact(tp)
    for k in at.CAPACITY_KNOBS:
        assert flag(k) == jax_flag(k)
