"""The port's host-plane modules against the JAX package's, fed the same
inputs, on the CPU.

* Registries driven by the same seeded sequence of counter / gauge /
  histogram calls give equal snapshots, identical Prometheus text and
  identical fleet merges (``merge_snapshots``,
  ``merged_prometheus_text``), and their histograms give equal
  quantiles and windowed views: the same arithmetic, so exact equality.
* A page-sanitizer journal dumped by either package's pool (the same
  seeded pool traffic, clean or with an injected bug) replays in the
  other package's ``replay_journal`` with the same verdict: clean, or
  the same rule at the same event.
* The same holds for the concurrency sanitizer's journals of the seeded
  interleaving fuzzer, whose dumps are byte-identical across packages.
* ``FaultInjector`` plans parsed from a spec or drawn from a seed are
  equal, and so are their event logs after the same consultations.
* SLO specs parse to the same config and give the same verdicts, and the
  watchdogs fire the same events over equal registries.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.framework import concurrency as jax_conc
from paddle_tpu.framework import telemetry as jax_tel
from paddle_tpu.framework import watchdog as jax_wd
from paddle_tpu.incubate.nn import fault_injection as jax_fi
from paddle_tpu.incubate.nn import page_sanitizer as jax_ps
from paddle_tpu.incubate.nn import PagedKVCacheManager as JaxPool

from paddle_tpu_torch.framework import concurrency as port_conc
from paddle_tpu_torch.framework import telemetry as port_tel
from paddle_tpu_torch.framework import watchdog as port_wd
from paddle_tpu_torch.incubate.nn import fault_injection as port_fi
from paddle_tpu_torch.incubate.nn import page_sanitizer as port_ps
from paddle_tpu_torch.incubate.nn import PagedKVCacheManager

HEADS, DIM, PAGE = 2, 4, 4


# ------------------------------------------------------------ registries
def _drive(reg, seed, n=400):
    """A seeded mix of counters, gauges and histogram observations over
    a few namespaces, with epoch advances and exemplars."""
    rng = np.random.RandomState(seed)
    names = ["serving.steps", "pool.page_allocs", "prefix.hits"]
    gauges = ["pool.free_pages", "serving.goodput", "pool.utilization",
              "serving.uptime_s"]
    hists = ["serving.ttft_s", "serving.tpot_s", "exec.wall_s.decode"]
    for i in range(n):
        op = rng.randint(4)
        if op == 0:
            reg.inc(names[rng.randint(3)], int(rng.randint(1, 5)))
        elif op == 1:
            reg.gauge(gauges[rng.randint(4)], float(rng.rand()))
        elif op == 2:
            v = float(rng.lognormal(-4, 2)) if rng.rand() > 0.05 else 0.0
            ex = "t%d" % i if rng.rand() < 0.2 else None
            reg.observe(hists[rng.randint(3)], v, exemplar=ex)
        else:
            reg.advance_epoch()
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_prometheus_text(seed):
    j = _drive(jax_tel.MetricsRegistry(), seed)
    t = _drive(port_tel.MetricsRegistry(), seed)
    js, ts = j.snapshot(), t.snapshot()
    assert ts == js
    assert port_tel.prometheus_text(ts) == jax_tel.prometheus_text(js)
    assert port_tel.prometheus_text(registry=t) == \
        jax_tel.prometheus_text(registry=j)


def test_merge_snapshots_and_fleet_exposition():
    snaps_j = {f"w{s}": _drive(jax_tel.MetricsRegistry(), s).snapshot()
               for s in range(3)}
    snaps_t = {f"w{s}": _drive(port_tel.MetricsRegistry(), s).snapshot()
               for s in range(3)}
    assert port_tel.merge_snapshots(snaps_t) == \
        jax_tel.merge_snapshots(snaps_j)
    assert port_tel.merged_prometheus_text(snaps_t) == \
        jax_tel.merged_prometheus_text(snaps_j)
    assert port_tel.merge_snapshots(list(snaps_t.values())) == \
        jax_tel.merge_snapshots(list(snaps_j.values()))


@pytest.mark.parametrize("n,samples", [(50, None), (5000, 256)])
def test_histogram_quantiles(n, samples):
    vals = np.random.RandomState(n).lognormal(-3, 1.5, n)
    hj, ht = jax_tel.Histogram(samples), port_tel.Histogram(samples)
    for i, v in enumerate(vals):
        hj.observe(float(v), epoch=i // 10)
        ht.observe(float(v), epoch=i // 10)
    for p in (0, 1, 50, 90, 99, 99.9, 100):
        assert ht.percentile(p) == hj.percentile(p)
    assert ht.summary() == hj.summary()
    assert ht.windowed(n // 20) == hj.windowed(n // 20)
    assert ht.buckets() == hj.buckets()


# ------------------------------------------------------- page sanitizer
def _pool_traffic(pool, kv, seed, tree=None, steps=60):
    """Seeded alloc / append / truncate / free traffic through the
    public pool API (``kv(n)`` makes the package's K/V rows)."""
    rng = np.random.RandomState(seed)
    live, nxt = [], 0
    for _ in range(steps):
        op = rng.randint(5)
        if op == 0 or not live:
            s = "s%d" % nxt
            nxt += 1
            pool.alloc(s)
            live.append(s)
            n = int(rng.randint(1, 7))
            if pool.ragged_pages_needed([s], [n]) <= pool.num_free_pages:
                pool.append_ragged([s], [n], kv(n), kv(n))
        elif op == 1:
            need = sum(1 for s in live if pool.seq_len(s) % PAGE == 0)
            if need <= pool.num_free_pages:
                pool.append_batch(list(live), kv(len(live)), kv(len(live)))
        elif op == 2:
            s = live[rng.randint(len(live))]
            pool.truncate(s, int(rng.randint(pool.seq_len(s) + 1)))
        elif op == 3:
            s = live.pop(rng.randint(len(live)))
            pool.free(s)
        else:
            pool.page_table(list(live))
        if rng.rand() < 0.1:
            pool.sanitizer_crosscheck()


def _jax_kv(n):
    return jnp.zeros((n, HEADS, DIM), jnp.float32)


def _port_kv(n):
    return torch.zeros(n, HEADS, DIM)


def _pools(mode="strict"):
    return (JaxPool(24, PAGE, HEADS, DIM, kv_dtype="float32",
                    sanitizer=mode),
            PagedKVCacheManager(24, PAGE, HEADS, DIM, kv_dtype="float32",
                                sanitizer=mode, device="cpu"))


@pytest.mark.parametrize("seed", [3, 4])
def test_clean_pool_journals_match_and_cross_replay(seed, tmp_path):
    jp, tp = _pools()
    _pool_traffic(jp, _jax_kv, seed)
    _pool_traffic(tp, _port_kv, seed)
    assert tp.sanitizer._events == jp.sanitizer._events
    pj = jp.sanitizer.dump(str(tmp_path / "jax.jsonl"))
    pt = tp.sanitizer.dump(str(tmp_path / "port.jsonl"))
    for path in (pj, pt):
        rj, rt = jax_ps.replay_journal(path), port_ps.replay_journal(path)
        assert rj.clean and rt.clean
        assert (rt.applied, rt.total) == (rj.applied, rj.total)
        assert rt.sanitizer._snapshot_state() == \
            rj.sanitizer._snapshot_state()


def _violating(pool, kv):
    """A double free after some traffic: the strict pool raises."""
    _pool_traffic(pool, kv, 5, steps=30)
    pool.alloc("x")
    pool.append_ragged(["x"], [3], kv(3), kv(3))
    pool.free("x")
    pool.free("x")


def test_violation_journals_cross_replay(tmp_path):
    jp, tp = _pools()
    with pytest.raises(jax_ps.PageSanitizerError) as ej:
        _violating(jp, _jax_kv)
    with pytest.raises(port_ps.PageSanitizerError) as et:
        _violating(tp, _port_kv)
    assert et.value.rule == ej.value.rule == "double-free"
    assert et.value.events == ej.value.events
    pj = jp.sanitizer.dump(str(tmp_path / "jax.jsonl"))
    pt = tp.sanitizer.dump(str(tmp_path / "port.jsonl"))
    for path in (pj, pt):
        rj, rt = jax_ps.replay_journal(path), port_ps.replay_journal(path)
        assert not rj.clean and not rt.clean
        assert rt.error.rule == rj.error.rule == "double-free"
        assert rt.applied == rj.applied


@pytest.mark.parametrize("inject", sorted(port_ps.INJECTIONS))
def test_fuzz_injections_caught_alike(inject, tmp_path):
    """Each injected bug class: both packages' fuzzers catch it with the
    same rule, and each journal replays to that rule in the other's
    replayer."""
    with pytest.raises(jax_ps.PageSanitizerError) as ej:
        jax_ps.fuzz_pool(seed=3, steps=300, inject=inject)
    with pytest.raises(port_ps.PageSanitizerError) as et:
        port_ps.fuzz_pool(seed=3, steps=300, inject=inject, device="cpu")
    assert et.value.rule == ej.value.rule == inject
    pj = ej.value.sanitizer.dump(str(tmp_path / "jax.jsonl"))
    pt = et.value.sanitizer.dump(str(tmp_path / "port.jsonl"))
    assert port_ps.replay_journal(pj).error.rule == inject
    assert jax_ps.replay_journal(pt).error.rule == inject


def test_clean_fuzz_stats_equal():
    for kv_dtype in ("float32", "int8"):
        for prefix in (True, False):
            a = jax_ps.fuzz_pool(seed=9, steps=120, kv_dtype=kv_dtype,
                                 prefix_cache=prefix)
            b = port_ps.fuzz_pool(seed=9, steps=120, kv_dtype=kv_dtype,
                                  prefix_cache=prefix, device="cpu")
            assert b == a, (kv_dtype, prefix)


# -------------------------------------------------- concurrency sanitizer
@pytest.mark.parametrize("inject", [None] + sorted(port_conc.INJECTIONS))
def test_concurrency_journals_identical_and_cross_replay(inject,
                                                         tmp_path):
    paths = []
    for mod in (jax_conc, port_conc):
        if inject is None:
            san = mod.ConcurrencySanitizer(mode="strict",
                                           journal_max=65536)
            lk = san.guarded("c.lock")
            var = san.shared("c.var", guard="c.lock")
            for _ in range(5):
                with lk:
                    var.write()
        else:
            with pytest.raises(mod.ConcurrencyError) as ei:
                mod.fuzz_interleavings(seed=3, steps=600, inject=inject,
                                       journal_max=65536)
            assert ei.value.rule == inject
            san = ei.value.sanitizer
        paths.append(san.dump(str(tmp_path / ("%s.jsonl"
                                              % mod.__name__))))
    if inject is not None:
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read()
    for path in paths:
        rj, rt = jax_conc.replay_journal(path), port_conc.replay_journal(
            path)
        assert rt.clean == rj.clean == (inject is None)
        assert rt.applied == rj.applied
        if inject is not None:
            assert rt.error.rule == rj.error.rule == inject


def test_clean_interleaving_fuzz_stats_equal():
    assert port_conc.fuzz_interleavings(seed=7, steps=300) == \
        jax_conc.fuzz_interleavings(seed=7, steps=300)


# -------------------------------------------------------- fault injection
@pytest.mark.parametrize("spec", [
    "exhaust@10+5,preempt_storm@20:2,fail_step@30+3",
    " , ,delay_swap_in@7, exhaust@1",
    "exhaust@4+3,preempt_storm@8:2,delay_swap_in@9+4,fail_step@14+3"])
def test_fault_plans_from_spec(spec):
    assert port_fi.parse_fault_plan(spec) == jax_fi.parse_fault_plan(spec)
    j, t = jax_fi.FaultInjector(spec), port_fi.FaultInjector(spec)
    assert t.plan == j.plan
    for step in range(1, 40):
        for inj in (j, t):
            inj.pool_exhausted(step)
            inj.forced_preemptions(step)
            inj.swap_in_delayed(step)
            inj.fail_step(step)
    assert t.events() == j.events()
    assert t.summary() == j.summary()


@pytest.mark.parametrize("seed", [0, 5, 17])
def test_fault_plans_from_seed(seed):
    j = jax_fi.FaultInjector.random(seed=seed, steps=120, n_faults=7)
    t = port_fi.FaultInjector.random(seed=seed, steps=120, n_faults=7)
    assert t.plan == j.plan
    assert port_fi.FAULT_KINDS == jax_fi.FAULT_KINDS


# ----------------------------------------------------- SLO and watchdog
@pytest.mark.parametrize("spec", [
    "", "ttft_p99_s=2", "ttft_p99_s=2,tpot_p99_s=0.2",
    "ttft_p99_s=0.5,tpot_p99_s=0.05,queue_wait_p99_s=1"])
def test_slo_config(spec):
    j = jax_tel.SLOConfig.from_flag(spec)
    t = port_tel.SLOConfig.from_flag(spec)
    assert t.to_dict() == j.to_dict() and t.enabled() == j.enabled()
    rng = np.random.RandomState(len(spec))
    for _ in range(20):
        ttft, tpot, qw = rng.exponential(0.5, 3)
        assert t.request_meets(ttft, tpot, qw) == \
            j.request_meets(ttft, tpot, qw)
    gaps = list(rng.exponential(0.05, 37))
    assert port_tel.SLOConfig.p99(gaps) == jax_tel.SLOConfig.p99(gaps)


def test_watchdogs_fire_alike():
    """Seeded registry traffic that trips several watchdog classes gives
    the same event log in both packages."""
    logs = []
    for tel, wd in ((jax_tel, jax_wd), (port_tel, port_wd)):
        reg = tel.MetricsRegistry()
        dog = wd.Watchdog(reg, mode="warn", window=8)
        rng = np.random.RandomState(0)
        for step in range(1, 121):
            reg.advance_epoch()
            reg.observe("serving.step_wall_s",
                        0.5 if step == 72 else 0.01 + 0.001 * rng.rand())
            reg.inc("serving.preempt_victims",
                    3 if 40 <= step < 60 else 0)
            reg.gauge("pool.utilization", 0.99 if step > 100 else 0.5)
            reg.inc("pool.page_allocs", int(rng.randint(5)))
            if step > 90:
                reg.inc("sanitizer.violations_seen", 1)
                reg.gauge("sanitizer.violations", float(step - 90))
            if step % 4 == 0:
                with _quiet():
                    dog.check(reg.epoch)
        # the wall stamp is the real clock's
        logs.append([{k: v for k, v in ev.items()
                      if k not in ("snapshot", "wall")}
                     for ev in dog.to_records()])
    assert logs[1] == logs[0]
    assert {ev["class"] for ev in logs[0]} >= {"decode-stall",
                                                "pool-pressure"}


class _quiet:
    """Silence the watchdogs' RuntimeWarnings inside a block."""

    def __enter__(self):
        import warnings

        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("ignore", RuntimeWarning)

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)
