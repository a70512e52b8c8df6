"""The port's runtime guards (``repro_torch.analysis``): ``trace_guard``
over the port's ``cache_size()`` counters (table layouts a control plane
ran on) and ``race_guard`` over the port's ``HostLog`` and ``CamBroker``
locks.  Everything runs on the CPU."""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.common import synthetic_controller_table  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis import race_guard as rg  # noqa: E402
from repro_torch.analysis.trace_guard import (TraceGuardError,  # noqa: E402
                                              assert_compiled_once,
                                              trace_guard)
from repro_torch.core import approx_comm as TAC  # noqa: E402
from repro_torch.core import controller as TC  # noqa: E402
from repro_torch.core import drift as TD  # noqa: E402
from repro_torch.core.broker import CamBroker  # noqa: E402
from repro_torch.core.channel import calibrated_channel  # noqa: E402
from repro_torch.core.log import HostLog  # noqa: E402

N = 4
REG = dict(slope=1.1e-6, intercept=0.012)


@dataclasses.dataclass
class _Cam:
    """What FleetController reads off a broker."""
    camera_id: str
    controller: object
    table_version: int = 0
    qos_version: int = 0


def table(n, gen=0):
    t = synthetic_controller_table(n, smin=2e3 + 500.0 * gen,
                                   smax=9e4 - 900.0 * gen)
    return convert.table_from_numpy(
        settings=[dataclasses.astuple(s) for s in t.settings],
        sizes_sorted=t.sizes_sorted, best_acc=t.best_acc,
        best_idx=t.best_idx, acc_by_setting=t.acc_by_setting,
        size_by_setting=t.size_by_setting)


def fleet_with_drift():
    reg = convert.regression_from_numpy(**REG)
    cams = [_Cam(f"cam{i}", TC.LatencyController(
        TC.ControllerConfig(latency_target=0.05, accuracy_target=0.92),
        table(12 + i), reg)) for i in range(N)]
    fleet = TC.FleetController(cams, capacity=32, device="cpu")
    monitor = TD.DriftMonitor([c.camera_id for c in cams],
                              TD.DriftConfig(window=4), device="cpu")
    fleet.attach_drift(monitor)
    return cams, fleet, monitor


def tick(fleet, rng):
    lat = rng.uniform(0.02, 0.12, N).astype(np.float32)
    fleet.tick(lat, np.ones(N, bool), rng.uniform(0, 0.1, N),
               np.ones(N, bool))


def test_swaps_and_retargets_keep_one_layout():
    """Table hot-swaps, retargets and a budget write inside one guarded
    block leave the fused tick -- and the monitor fused into it -- on one
    table layout."""
    cams, fleet, monitor = fleet_with_drift()
    rng = np.random.default_rng(0)
    assert fleet.cache_size() == monitor.cache_size() == 0
    with trace_guard(fleet, monitor):
        for step in range(12):
            if step == 3:
                cams[1].controller.swap_table(table(20, gen=1))
                cams[1].table_version += 1
            if step == 6:
                cams[2].controller.set_target(0.08, 0.91)
                cams[2].qos_version += 1
            if step == 9:
                fleet.set_budget_scale(0.5)
            tick(fleet, rng)
    assert fleet.cache_size() == monitor.cache_size() == 1
    assert_compiled_once(fleet.cache_size(), "fleet tick")


def test_capacity_growth_is_a_second_layout():
    """A table that outgrows the shared capacity rebuilds the stack at a
    new (lanes, capacity) layout: the count goes to 2 and a guard that
    allows one layout fails, naming the move."""
    cams, fleet, monitor = fleet_with_drift()
    rng = np.random.default_rng(1)
    tick(fleet, rng)
    cams[0].controller.swap_table(table(40))
    cams[0].table_version += 1
    with pytest.raises(TraceGuardError, match="1 -> 2"):
        with trace_guard(fleet):
            tick(fleet, rng)
    assert fleet.capacity == 40
    assert fleet.cache_size() == monitor.cache_size() == 2
    with pytest.raises(TraceGuardError, match="got 2"):
        assert_compiled_once(fleet.cache_size(), "fleet tick")
    with trace_guard(fleet, expect=2):
        tick(fleet, rng)


def test_unfused_monitor_counts_its_own_layout():
    """A monitor that is not fused into a fleet counts its own update:
    threshold changes are value writes and keep one layout."""
    m = TD.DriftMonitor(["a", "b"], TD.DriftConfig(window=4), device="cpu")
    with trace_guard(m):
        m.observe({"a": 0.1})
        m.params = TD.DriftParams.from_config(
            TD.DriftConfig(window=4, hi=0.9, lo=0.4), 2, device="cpu")
        m.observe({"a": 0.1, "b": 2.0})
    assert m.cache_size() == 1


def test_collective_controller_keeps_one_layout():
    ctl = TAC.CollectiveController(
        4e6, {16: 1.0, 8: 0.999, 4: 0.985}, latency_target=0.002,
        slope=1 / 3e9, device="cpu")
    with trace_guard(ctl):
        for lat in (0.001, 0.004, 0.003, 0.0015):
            ctl.update(lat)
    assert ctl.cache_size() == 1


class _Counter:
    def __init__(self, size=0):
        self.n = size

    def cache_size(self):
        return self.n


@pytest.mark.parametrize("start,grow,expect,fails", [
    (0, 1, 1, False),       # a cold target's first layout
    (0, 2, 1, True),        # a second layout in the block
    (3, 0, 1, False),       # a warm target that stays
    (3, 1, 1, True),        # a warm target that moves
    (0, 2, 2, False),       # an allowance of two
])
def test_trace_guard_allowance(start, grow, expect, fails):
    target = _Counter(start)

    def block():
        with trace_guard(target, expect=expect):
            target.n += grow

    if fails:
        with pytest.raises(TraceGuardError, match="_Counter#0"):
            block()
    else:
        block()


class _PermissiveRW:
    """An RW lock that excludes nothing: the guard must notice."""

    def acquire_read(self):
        pass

    def release_read(self):
        pass

    def acquire_write(self):
        pass

    def release_write(self):
        pass


def test_race_guard_catches_a_broken_hostlog_segment_lock():
    """A HostLog built inside the guard is instrumented; with one segment's
    lock made permissive, a reader admitted while a writer holds it is a
    recorded violation (and strict mode raises it on exit)."""
    with rg.race_guard(strict=False) as guard:
        log = HostLog(8, num_segments=1)
        log.append(0.0, np.zeros((2, 2), np.uint8))
        seg = log._seg_locks[0]
        assert isinstance(seg, rg._RWLockProxy)
        assert isinstance(log._meta_lock, rg._LockProxy)
        seg._inner = _PermissiveRW()
        inside, done = threading.Event(), threading.Event()

        def writer():
            seg.acquire_write()
            inside.set()
            done.wait(5.0)
            seg.release_write()

        t = threading.Thread(target=writer)
        t.start()
        try:
            assert inside.wait(5.0)
            assert log.point_query(1.0) is not None   # reads the segment
        finally:
            done.set()
            t.join(5.0)
        assert not t.is_alive()
    assert any("reader admitted while a writer" in v
               for v in guard.violations)
    with pytest.raises(rg.RaceGuardError, match="writer admitted"):
        with rg.race_guard():
            log = HostLog(8, num_segments=1)
            log._seg_locks[0]._inner = _PermissiveRW()
            log._seg_locks[0].acquire_write()
            log._seg_locks[0].acquire_write()


def test_race_guard_catches_a_lock_order_cycle():
    guard = rg.race_guard(strict=False)
    a = rg._LockProxy(threading.Lock(), guard.shared, "A")
    b = rg._LockProxy(threading.Lock(), guard.shared, "B")
    with a, b:
        pass
    with b, a:
        pass
    assert any("lock-order cycle" in v for v in guard.violations)


def test_race_guard_hostlog_soak_is_clean_and_patches_restored():
    """Threaded appends and queries on the port's HostLog record nothing;
    a CamBroker built inside is instrumented too, and leaving the guard
    restores both constructors."""
    init_log, init_cam = HostLog.__init__, CamBroker.__init__
    with rg.race_guard() as guard:
        cam = CamBroker("cam0", calibrated_channel(seed=0), device="cpu")
        assert isinstance(cam._version_lock, rg._LockProxy)
        log = HostLog(32, num_segments=4)
        frame = np.zeros((4, 4), np.uint8)
        stop = threading.Event()

        def reader():
            while not stop.is_set():
                log.point_query(1e9)
                len(log)

        threads = [threading.Thread(target=reader) for _ in range(2)]
        for t in threads:
            t.start()
        try:
            for i in range(400):
                log.append(float(i), frame)
        finally:
            stop.set()
            for t in threads:
                t.join(5.0)
        assert not any(t.is_alive() for t in threads)
    assert guard.violations == []
    assert HostLog.__init__ is init_log and CamBroker.__init__ is init_cam


@pytest.mark.parametrize("value", ["1", "0", None])
def test_race_guard_from_env_matches_jax(monkeypatch, value):
    """``from_env`` gives one guard (strict, nothing recorded) where
    ``MEZLINT_RACE_GUARD=1`` and ``None`` otherwise, as the JAX package's
    does."""
    from repro.analysis import race_guard as jrg
    if value is None:
        monkeypatch.delenv("MEZLINT_RACE_GUARD", raising=False)
    else:
        monkeypatch.setenv("MEZLINT_RACE_GUARD", value)
    got, want = rg.from_env(), jrg.from_env()
    assert (got is None) == (want is None) == (value != "1")
    if got is not None:
        assert isinstance(got, rg.race_guard) and got.strict
        assert got.violations == []


def test_trace_guard_needs_cache_size():
    with pytest.raises(TypeError, match="cache_size"):
        with trace_guard(object()):
            pass
