"""The port's concurrency sanitizer (paddle_tpu_torch/framework/
concurrency.py), by the reference's own unit tests: lockset golden
semantics per violation class, the vector-clock happens-before model
across real threads / asyncio tasks / executor hops, journal dump +
--replay reconstruction to the first violation, every injected fuzzer
bug class caught with the matching rule, seed determinism
(byte-identical journals), the instrumented serving/telemetry plane
running strict-clean under a live scraper thread, and the off-mode
zero-allocation contract. Host-only.

Left out: the rule-inventory case of ``framework.analysis`` (the jaxpr
lint, which the port does not have)."""
import asyncio
import contextlib
import threading
import tracemalloc

import numpy as np
import pytest

from paddle_tpu_torch.framework import concurrency, telemetry
from paddle_tpu_torch.framework.concurrency import (
    INJECTIONS,
    VIOLATIONS,
    ConcurrencyError,
    ConcurrencySanitizer,
    fuzz_interleavings,
    replay_journal,
)
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.inference import BatchScheduler, Request


@contextlib.contextmanager
def _as_actor(san, name, kind="thread", loop=None, sanction=True):
    """Pin a virtual actor identity (the fuzzer/replay hook) so one
    test thread can play several actors."""
    if sanction:
        san.sanction(name, kind, loop, label="test")
    concurrency._virtual.actor = (name, kind, loop)
    try:
        yield
    finally:
        concurrency._virtual.actor = None


@pytest.fixture
def san():
    return ConcurrencySanitizer(mode="strict", journal_max=4096)


@pytest.fixture
def conc_off():
    """Guarantee a pristine off-mode world (and leave one behind)."""
    set_flags({"concurrency_sanitizer": "off"})
    concurrency.reset()
    telemetry.reset()
    yield
    set_flags({"concurrency_sanitizer": "off", "telemetry": "off"})
    concurrency.reset()
    telemetry.reset()


@pytest.fixture
def conc_strict():
    set_flags({"concurrency_sanitizer": "strict"})
    concurrency.reset()
    telemetry.reset()
    yield concurrency.sanitizer()
    set_flags({"concurrency_sanitizer": "off", "telemetry": "off"})
    concurrency.reset()
    telemetry.reset()


# -- a host-only fake model implementing the scheduler protocol --------------


class _FakeCache:
    def __init__(self, num_pages=1024, page_size=4):
        self.num_pages = num_pages
        self.page_size = page_size
        self.lens = {}

    @property
    def num_free_pages(self):
        used = sum(-(-n // self.page_size) if n else 0
                   for n in self.lens.values())
        return self.num_pages - used

    def seq_len(self, s):
        return self.lens[s]

    def truncate(self, s, n):
        self.lens[s] = n

    def attach(self, s, pages, length):
        self.lens[s] = int(length)

    def seq_pages(self, s):
        return []

    def pending_cow(self, s):
        return False


class _FakeModel:
    """Deterministic token-per-step decoder: always emits token 1."""

    def __init__(self, vocab=16, num_pages=1024):
        self.vocab = vocab
        self.caches = [_FakeCache(num_pages=num_pages)]

    def alloc(self, sid):
        self.caches[0].lens[sid] = 0

    def free(self, sid):
        del self.caches[0].lens[sid]

    def attach_prefix(self, sid, chains, length):
        for c, chain in zip(self.caches, chains):
            c.attach(sid, chain, length)

    def seq_page_chains(self, sid):
        return [c.seq_pages(sid) for c in self.caches]

    def decode_token(self, feed, sids):
        c = self.caches[0]
        for s in sids:
            c.lens[s] += 1
        logits = np.zeros((len(sids), self.vocab), np.float32)
        logits[:, 1] = 1.0
        return logits


# -- lockset golden semantics ------------------------------------------------


class TestLocksetGoldens:
    def test_guarded_write_with_guard_held_is_clean(self, san):
        lk = san.guarded("g.lock")
        var = san.shared("g.var", guard="g.lock")
        with lk:
            var.write()
        assert san.violations == 0

    def test_write_without_declared_guard_violates(self, san):
        san.guarded("g.lock")
        var = san.shared("g.var", guard="g.lock")
        with pytest.raises(ConcurrencyError) as ei:
            var.write()
        assert ei.value.rule == "unguarded-shared-write"

    def test_wrong_lock_does_not_satisfy_the_guard(self, san):
        other = san.guarded("g.other")
        var = san.shared("g.var", guard="g.lock")
        with other:
            with pytest.raises(ConcurrencyError) as ei:
                var.write()
        assert ei.value.rule == "unguarded-shared-write"

    def test_single_writer_claim_and_second_writer(self, san):
        var = san.shared("sw.var", single_writer=True)
        with _as_actor(san, "v:owner"):
            var.write()
            var.write()  # same writer: fine
        with _as_actor(san, "v:reader"):
            var.read()  # single-writer reads are unchecked
        with _as_actor(san, "v:intruder"):
            with pytest.raises(ConcurrencyError) as ei:
                var.write()
        assert ei.value.rule == "unguarded-shared-write"

    def test_guardless_read_write_race(self, san):
        var = san.shared("r.var")
        with _as_actor(san, "v:writer"):
            var.write()
        with _as_actor(san, "v:reader"):
            with pytest.raises(ConcurrencyError) as ei:
                var.read()
        assert ei.value.rule == "lockset-race"

    def test_common_lock_suppresses_the_race(self, san):
        lk = san.guarded("r.lock")
        var = san.shared("r.var")
        with _as_actor(san, "v:writer"):
            with lk:
                var.write()
        with _as_actor(san, "v:reader"):
            with lk:
                var.read()
        assert san.violations == 0

    def test_release_acquire_happens_before_suppresses(self, san):
        """A lock hand-off orders the access pair even when the
        later read happens OUTSIDE the lock: release publishes the
        writer's clock, acquire joins it."""
        lk = san.guarded("hb.lock")
        var = san.shared("hb.var")
        with _as_actor(san, "v:writer"):
            var.write()  # no lock held
            with lk:
                pass  # release publishes writer's clock
        with _as_actor(san, "v:reader"):
            with lk:
                pass  # acquire joins it: HB edge established
            var.read()  # no lock held, but ordered
        assert san.violations == 0

    def test_write_write_race(self, san):
        var = san.shared("ww.var")
        with _as_actor(san, "v:w1"):
            var.write()
        with _as_actor(san, "v:w2"):
            with pytest.raises(ConcurrencyError) as ei:
                var.write()
        assert ei.value.rule == "lockset-race"

    def test_lock_order_inversion(self, san):
        l1 = san.guarded("o.l1")
        l2 = san.guarded("o.l2")
        with _as_actor(san, "v:a"):
            with l1:
                with l2:
                    pass
        with _as_actor(san, "v:b"):
            with l2:
                with pytest.raises(ConcurrencyError) as ei:
                    l1.acquire()
        assert ei.value.rule == "lock-order-inversion"

    def test_consistent_lock_order_is_clean(self, san):
        l1 = san.guarded("o.l1")
        l2 = san.guarded("o.l2")
        for actor in ("v:a", "v:b"):
            with _as_actor(san, actor):
                with l1:
                    with l2:
                        pass
        assert san.violations == 0

    def test_blocking_acquire_on_loop(self, san):
        lk = san.guarded("t.lock")
        with _as_actor(san, "v:task", kind="task", loop="v-loop"):
            with pytest.raises(ConcurrencyError) as ei:
                lk.acquire()
        assert ei.value.rule == "blocking-acquire-on-loop"

    def test_nonblocking_acquire_on_loop_is_clean(self, san):
        lk = san.guarded("t.lock")
        with _as_actor(san, "v:task", kind="task", loop="v-loop"):
            assert lk.acquire(blocking=False)
            lk.release()
        assert san.violations == 0

    def test_unsanctioned_thread_write(self, san):
        var = san.shared("u.var")
        with _as_actor(san, "v:rogue", sanction=False):
            with pytest.raises(ConcurrencyError) as ei:
                var.write()
        assert ei.value.rule == "unsanctioned-thread"

    def test_adopt_sanctions_the_current_thread(self, san):
        var = san.shared("u.var")
        errors = []

        def worker():
            try:
                san.adopt("test-worker")
                var.write()
            except ConcurrencyError as e:  # pragma: no cover
                errors.append(e)

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert not errors
        assert san.violations == 0

    def test_off_mode_construction_is_rejected(self):
        with pytest.raises(ValueError, match="do not construct"):
            ConcurrencySanitizer(mode="off")

    def test_error_carries_rule_and_journal_tail(self, san):
        var = san.shared("g.var", guard="g.lock")
        with pytest.raises(ConcurrencyError) as ei:
            var.write()
        e = ei.value
        assert e.rule in VIOLATIONS
        assert e.events and e.events[-1]["op"] == "write"
        assert "journal tail" in str(e)

    def test_warn_mode_reports_and_continues(self, san):
        wsan = ConcurrencySanitizer(mode="warn")
        var = wsan.shared("g.var", guard="g.lock")
        with pytest.warns(RuntimeWarning, match="unguarded"):
            var.write()
        var.read()  # execution continues
        assert wsan.violations_by_rule["unguarded-shared-write"] == 1


# -- happens-before across threads, tasks, and executor hops -----------------


class TestHappensBefore:
    def test_fork_begin_thread_edge(self, san):
        """Everything before the spawn happens-before everything in
        the child: the child reads the parent's write race-free and
        is sanctioned by the spawn event."""
        var = san.shared("hb.var")
        var.write()  # main (constructing) thread, sanctioned
        parent_vc = san.fork()
        errors = []

        def child():
            try:
                san.begin_thread("hb-child", parent_vc)
                var.read()
                var.write()
            except ConcurrencyError as e:  # pragma: no cover
                errors.append(e)

        t = threading.Thread(target=child)
        t.start()
        t.join()
        assert not errors
        assert san.violations == 0

    def test_thread_without_fork_edge_races(self, san):
        var = san.shared("hb.var")
        var.write()
        caught = []

        def child():
            san.adopt("no-edge-child")  # sanctioned but unordered
            try:
                var.read()
            except ConcurrencyError as e:
                caught.append(e)

        t = threading.Thread(target=child)
        t.start()
        t.join()
        assert caught and caught[0].rule == "lockset-race"

    def test_task_switch_is_an_hb_edge(self, san):
        """Two guardless, lockless accesses from two asyncio tasks on
        one loop: the loop clock orders them — clean."""
        var = san.shared("loop.var")

        async def writer():
            var.write()

        async def reader():
            var.read()

        async def main():
            await asyncio.gather(writer(), reader())

        asyncio.run(main())
        assert san.violations == 0

    def test_executor_hop_is_not_an_hb_edge(self, san):
        """run_in_executor lands on a plain worker thread that never
        syncs through the loop clock: the same pair races."""
        var = san.shared("exec.var")

        async def main():
            var.write()  # in the main task
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, var.read)

        with pytest.raises(ConcurrencyError) as ei:
            asyncio.run(main())
        assert ei.value.rule == "lockset-race"

    def test_spawn_thread_helper_wires_the_edge(self, conc_strict):
        """The sanctioned helper (satellite: ops-server + recorder
        threads route through it) gives child threads the fork/join
        edge for free."""
        san = conc_strict
        var = san.shared("helper.var")
        var.write()
        errors = []

        def child():
            try:
                var.read()
                var.write()
            except ConcurrencyError as e:  # pragma: no cover
                errors.append(e)

        t = concurrency.spawn_thread("helper-child", child,
                                     daemon=False)
        t.join()
        assert not errors
        assert t.name == "helper-child"
        assert san.violations == 0


# -- journal: dump, replay, fuzz injections, determinism ---------------------


class TestJournalAndFuzzer:
    def test_clean_fuzz_run(self):
        stats = fuzz_interleavings(seed=0, steps=400,
                                   journal_max=65536)
        assert stats["violations"] == 0
        assert stats["events"] > 100
        assert stats["inject"] is None

    @pytest.mark.parametrize("inject", sorted(INJECTIONS))
    def test_injected_bug_caught_and_replayed(self, inject,
                                              tmp_path):
        """Every injected class must be caught live with the
        matching rule AND reconstructed by --replay to the same
        first violation."""
        with pytest.raises(ConcurrencyError) as ei:
            fuzz_interleavings(seed=3, steps=600, inject=inject,
                               journal_max=65536)
        e = ei.value
        assert e.rule == inject
        path = str(tmp_path / ("%s.jsonl" % inject))
        e.sanitizer.dump(path)
        res = replay_journal(path)
        assert not res.clean
        assert res.error.rule == inject
        # replay stops at the SAME event the live run flagged
        assert res.sanitizer._events[-1]["i"] == e.events[-1]["i"]
        vios = res.sanitizer._events[-1].get("violations", [])
        assert any(v["rule"] == inject for v in vios)

    def test_seed_determinism_stats(self):
        a = fuzz_interleavings(seed=7, steps=300, journal_max=65536)
        b = fuzz_interleavings(seed=7, steps=300, journal_max=65536)
        assert a == b

    def test_seed_determinism_byte_identical_journals(self,
                                                      tmp_path):
        paths = []
        for run in range(2):
            with pytest.raises(ConcurrencyError) as ei:
                fuzz_interleavings(seed=11, steps=600,
                                   inject="lockset-race",
                                   journal_max=65536)
            p = str(tmp_path / ("run%d.jsonl" % run))
            ei.value.sanitizer.dump(p)
            paths.append(p)
        with open(paths[0], "rb") as f0, open(paths[1], "rb") as f1:
            assert f0.read() == f1.read()

    def test_journal_rollover_keeps_tail(self, tmp_path):
        san = ConcurrencySanitizer(mode="strict", journal_max=16)
        var = san.shared("roll.var", single_writer=True)
        for _ in range(100):
            var.write()
        tail = san.tail(8)
        assert len(tail) == 8
        assert tail[-1]["i"] == 100  # reg event + 100 writes
        # the post-rollover journal still replays clean
        path = str(tmp_path / "roll.jsonl")
        san.dump(path)
        assert replay_journal(path).clean

    def test_clean_journal_replays_clean(self, san, tmp_path):
        lk = san.guarded("c.lock")
        var = san.shared("c.var", guard="c.lock")
        for _ in range(5):
            with lk:
                var.write()
        path = str(tmp_path / "clean.jsonl")
        san.dump(path)
        res = replay_journal(path)
        assert res.clean
        assert "replays clean" in res.summary()

    def test_cli_fuzz_inject_exit_codes(self, capsys):
        rc = concurrency.main(["--fuzz", "--seed", "3",
                               "--inject", "lock-order-inversion"])
        assert rc == 0
        assert "CAUGHT" in capsys.readouterr().out

    def test_cli_fuzz_clean_and_replay(self, tmp_path, capsys,
                                       san):
        assert concurrency.main(["--fuzz", "--seed", "5"]) == 0
        # a violating journal exits 1 from --replay
        var = san.shared("cli.var", guard="cli.lock")
        with pytest.raises(ConcurrencyError):
            var.write()
        bad = str(tmp_path / "bad.jsonl")
        san.dump(bad)
        assert concurrency.main(["--replay", bad]) == 1
        out = capsys.readouterr().out
        assert "first violation [unguarded-shared-write]" in out


# -- the instrumented serving/telemetry plane --------------------------------


class TestInstrumentedPlane:
    def test_strict_serving_run_is_clean(self, conc_strict):
        """A full scheduler run under strict mode: the instrumented
        queue/active/swap writes all carry their declared discipline
        — zero violations, and the journal saw real events."""
        san = conc_strict
        sched = BatchScheduler(_FakeModel(), max_batch_size=4)
        for i in range(6):
            sched.submit(Request("r%d" % i, [2, 3, 4],
                                 max_new_tokens=4))
        done = sched.run_until_complete()
        assert len(done) == 6
        st = san.stats()
        assert st["violations"] == 0
        assert st["events"] > 0
        assert san.has_events()

    def test_registry_scrape_vs_step_two_threads(self, conc_strict):
        """Satellite regression: counter()/gauge_value()/histogram()
        are now locked reads — a scraper thread hammering them
        against a mutating step loop is race-free under strict."""
        set_flags({"telemetry": "metrics"})
        telemetry.reset()
        reg = telemetry.registry()
        san = conc_strict
        stop = threading.Event()
        errors = []

        def scrape():
            try:
                while not stop.is_set():
                    reg.counter("serving.steps")
                    reg.gauge_value("serving.active")
                    reg.histogram("serving.step_ms")
                    reg.hist_windowed("serving.step_ms", 0)
                    reg.snapshot()
            except ConcurrencyError as e:  # pragma: no cover
                errors.append(e)

        t = concurrency.spawn_thread("test-scraper", scrape,
                                     daemon=False)
        for i in range(200):
            reg.inc("serving.steps")
            reg.gauge("serving.active", i % 7)
            reg.observe("serving.step_ms", 0.5 + i * 0.01)
            if i % 50 == 0:
                reg.advance_epoch()
        stop.set()
        t.join()
        assert not errors
        assert san.violations == 0

    def test_tracebook_begin_event_get_two_threads(self,
                                                   conc_strict):
        """Satellite regression: begin() appends the submit event
        under the lock and event()/get() are fully locked — a reader
        thread iterating traces mid-begin is race-free."""
        san = conc_strict
        book = telemetry.RequestTraceBook(capacity=32)
        stop = threading.Event()
        errors = []

        def reader():
            try:
                while not stop.is_set():
                    book.get("r1")
                    book.traces()
            except ConcurrencyError as e:  # pragma: no cover
                errors.append(e)

        t = concurrency.spawn_thread("test-trace-reader", reader,
                                     daemon=False)
        for i in range(100):
            rid = "r%d" % (i % 4)
            book.begin(rid, float(i), epoch=i)
            book.event(rid, "token", float(i) + 0.5, epoch=i)
            if i % 4 == 3:
                book.complete(rid, "retire", float(i) + 0.9,
                              epoch=i)
        stop.set()
        t.join()
        assert not errors
        assert san.violations == 0

    def test_strict_audit_catches_a_seeded_registry_race(self,
                                                         conc_strict):
        """The audit has teeth against the real registry: bypassing
        the registry lock on a metrics write (what the pre-fix code
        did from the scrape path) is flagged."""
        set_flags({"telemetry": "metrics"})
        telemetry.reset()
        reg = telemetry.registry()
        with pytest.raises(ConcurrencyError) as ei:
            reg._cv.write()  # a write with telemetry.registry NOT held
        assert ei.value.rule == "unguarded-shared-write"

    def test_incident_context_carries_journal_tail(self,
                                                   conc_strict):
        san = conc_strict
        sched = BatchScheduler(_FakeModel(), max_batch_size=2)
        sched.submit(Request("r0", [2, 3], max_new_tokens=2))
        sched.run_until_complete()
        assert san.has_events()
        tail = san.tail(16)
        assert tail and all("op" in ev for ev in tail)


# -- off mode: the zero-cost contract ----------------------------------------


class TestOffMode:
    def test_sanitizer_is_none_and_guarded_is_plain(self, conc_off):
        assert concurrency.sanitizer() is None
        lk = concurrency.guarded("off.lock")
        assert isinstance(lk, type(threading.Lock()))
        rlk = concurrency.guarded("off.rlock", reentrant=True)
        assert isinstance(rlk, type(threading.RLock()))

    def test_spawn_thread_off_is_a_plain_named_thread(self,
                                                      conc_off):
        ran = []
        t = concurrency.spawn_thread("off-child", ran.append,
                                     args=(1,), daemon=False)
        t.join()
        assert ran == [1]
        assert t.name == "off-child"

    def test_bogus_flag_value_is_rejected(self, conc_off):
        set_flags({"concurrency_sanitizer": "bogus"})
        concurrency.reset()
        with pytest.raises(ValueError, match="must be one of"):
            concurrency.sanitizer()
        set_flags({"concurrency_sanitizer": "off"})
        concurrency.reset()

    def test_serving_loop_allocates_nothing_in_concurrency(
            self, conc_off):
        """FLAGS_concurrency_sanitizer=off over a full scheduler run
        must allocate ZERO tracemalloc blocks inside concurrency.py
        — the instrumented modules pay one `is None` check and
        nothing else."""
        sched = BatchScheduler(_FakeModel(), max_batch_size=4)
        reqs = [Request("r%d" % i, [2, 3, 4], max_new_tokens=4)
                for i in range(3)]
        for r in reqs:
            sched.submit(r)
        tracemalloc.start()
        snap0 = tracemalloc.take_snapshot()
        late = Request("late", [2, 3], max_new_tokens=2)
        sched.submit(late)
        sched.run_until_complete()
        snap1 = tracemalloc.take_snapshot()
        tracemalloc.stop()
        filt = [tracemalloc.Filter(True, concurrency.__file__)]
        diff = snap1.filter_traces(filt).compare_to(
            snap0.filter_traces(filt), "filename")
        new_blocks = sum(max(d.count_diff, 0) for d in diff)
        assert new_blocks == 0, (
            "FLAGS_concurrency_sanitizer=off allocated %d blocks in "
            "concurrency.py — the off-is-free contract is broken"
            % new_blocks)


# -- rule inventory ----------------------------------------------------------


class TestInventory:
    def test_violations_cover_the_injection_set(self):
        assert set(INJECTIONS) == set(VIOLATIONS)
        assert len(VIOLATIONS) >= 5
