"""The port's control plane against the JAX package: a 16-lane fused fleet
tick (PI step + drift monitor + knob-code gather) and the host
``LatencyController``, driven through one sequence of latencies, drift
residuals, subset table swaps, drift-fired swaps with re-ticks and
retargets.  Per-lane setting indices, feasibility, acted flags and drift
fires must be identical at every step."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.common import synthetic_controller_table  # noqa: E402
from repro.core import controller as JC  # noqa: E402
from repro.core import drift as JD  # noqa: E402
from repro.core.characterization import LatencyRegression  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import controller as TC  # noqa: E402
from repro_torch.core import drift as TD  # noqa: E402

N = 16
REG = dict(slope=1.2e-6, intercept=0.008)


def port_table(t):
    """A JAX-side CharacterizationTable carried across as NumPy arrays."""
    return convert.table_from_numpy(
        settings=[(s.resolution, s.colorspace, s.blur, s.artifact, s.diff)
                  for s in t.settings],
        sizes_sorted=t.sizes_sorted, best_acc=t.best_acc,
        best_idx=t.best_idx, acc_by_setting=t.acc_by_setting,
        size_by_setting=t.size_by_setting, min_accuracy=t.min_accuracy,
        source=t.source, activity=t.activity,
        residual_spread=t.residual_spread)


@dataclasses.dataclass
class _Cam:
    """What FleetController reads off a broker."""
    camera_id: str
    controller: object
    table_version: int = 0
    qos_version: int = 0


def table_for(i, gen=0):
    return synthetic_controller_table(12 + (i * 7 + gen * 5) % 29,
                                      smin=2e3 + 37.0 * i + 500.0 * gen,
                                      smax=9e4 - 101.0 * i - 900.0 * gen)


def config_for(i):
    return dict(latency_target=0.040 + 0.001 * (i % 17),
                accuracy_target=0.90 + 0.01 * (i % 7))


def build(drift_cfg):
    jreg = LatencyRegression(**REG)
    treg = convert.regression_from_numpy(**REG)
    jcams, tcams = [], []
    for i in range(N):
        jt = table_for(i)
        jcams.append(_Cam(f"cam{i:02d}", JC.LatencyController(
            JC.ControllerConfig(**config_for(i)), jt, jreg)))
        tcams.append(_Cam(f"cam{i:02d}", TC.LatencyController(
            TC.ControllerConfig(**config_for(i)), port_table(jt), treg)))
    jfleet = JC.FleetController(jcams, capacity=48)
    tfleet = TC.FleetController(tcams, capacity=48, device="cpu")
    ids = [c.camera_id for c in jcams]
    jfleet.attach_drift(JD.DriftMonitor(ids, JD.DriftConfig(**drift_cfg)))
    tfleet.attach_drift(TD.DriftMonitor(ids, TD.DriftConfig(**drift_cfg),
                                        device="cpu"))
    return jcams, tcams, jfleet, tfleet


def assert_same(jres, tres, step):
    for cid in jres:
        a, b = jres[cid], tres[cid]
        assert b.setting_index == a.setting_index, (step, cid)
        assert b.feasible == a.feasible, (step, cid)
        assert b.acted == a.acted, (step, cid)
        assert b.setting == (None if a.setting is None else
                             type(b.setting)(*dataclasses.astuple(a.setting)))
        assert b.requested_size == pytest.approx(a.requested_size, rel=1e-6)


def swap(jcams, tcams, i, gen):
    jt = table_for(i, gen)
    for cams, t in ((jcams, jt), (tcams, port_table(jt))):
        cams[i].controller.swap_table(t)
        cams[i].table_version += 1


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_fleet_tick_matches_jax(seed):
    rng = np.random.default_rng(seed)
    drift_cfg = dict(window=4, hi=0.45, lo=0.2, min_samples=2)
    jcams, tcams, jfleet, tfleet = build(drift_cfg)
    fires = 0
    for step in range(40):
        if step == 12:                  # re-characterization lands on a subset
            for i in (2, 7, 11):
                swap(jcams, tcams, i, 1)
        if step == 20:                  # live QoS renegotiation on another
            for i in (0, 5, 15):
                for cams in (jcams, tcams):
                    cams[i].controller.set_target(0.075, 0.91)
                    cams[i].qos_version += 1
        lat = rng.uniform(0.005, 0.4, N).astype(np.float32)
        valid = rng.random(N) < 0.85
        errs = rng.uniform(0.0, 0.9, N).astype(np.float32)
        dvalid = rng.random(N) < 0.7
        jres = jfleet.tick(lat, valid, errs, dvalid)
        tres = tfleet.tick(lat, valid, errs, dvalid)
        assert tres.fired_cams == jres.fired_cams, step
        assert_same(jres, tres, step)
        if jres.fired_cams:             # drift fired: refresh + re-decide
            fires += len(jres.fired_cams)
            for cid in jres.fired_cams:
                swap(jcams, tcams, jfleet.lane_of[cid], 2 + step)
            assert_same(jfleet.retick(), tfleet.retick(), step)
        np.testing.assert_array_equal(tfleet.state.current_idx.numpy(),
                                      np.asarray(jfleet.state.current_idx))
        np.testing.assert_array_equal(
            tfleet._drift.state.fires.numpy(),
            np.asarray(jfleet._drift.state.fires))
    assert fires > 0


def test_host_controller_matches_jax():
    rng = np.random.default_rng(3)
    jreg = LatencyRegression(**REG)
    treg = convert.regression_from_numpy(**REG)
    for i in range(4):
        jt = table_for(i)
        jc = JC.LatencyController(JC.ControllerConfig(**config_for(i)), jt,
                                  jreg)
        tc = TC.LatencyController(TC.ControllerConfig(**config_for(i)),
                                  port_table(jt), treg)
        for step in range(30):
            if step == 15:
                jc.set_target(0.06, 0.92)
                tc.set_target(0.06, 0.92)
            lat = float(rng.uniform(0.005, 0.4))
            a, b = jc.update(lat), tc.update(lat)
            assert (b.setting_index, b.feasible, b.acted) == \
                (a.setting_index, a.feasible, a.acted), (i, step)
            assert b.requested_size == a.requested_size
            assert tc.integral == jc.integral


def test_controller_step_matches_jax():
    """The single-camera device step over padded tables."""
    jt = table_for(3)
    kw = dict(latency_target=0.05, accuracy_target=0.93, **REG)
    jtab = JC.JaxControllerTables.from_table(jt, capacity=40)
    ttab = TC.ControllerTables.from_table(port_table(jt), capacity=40,
                                          device="cpu")
    js, ts = JC.controller_init(jtab), TC.controller_init(ttab)
    for lat in np.linspace(0.005, 0.3, 25):
        js, jidx = JC.controller_step(js, float(lat), jtab, **kw)
        ts, tidx = TC.controller_step(ts, float(lat), ttab, **kw)
        assert int(tidx) == int(jidx)
        assert float(ts.integral) == float(js.integral)


def test_controller_tables_carried_across():
    """Padded JAX-side tables converted with ``convert`` equal the port's
    own ``ControllerTables.from_table``."""
    jt = table_for(5)
    jtab = JC.JaxControllerTables.from_table(jt, capacity=40)
    conv = convert.controller_tables_from_numpy(
        **{f: np.asarray(getattr(jtab, f))
           for f in TC.ControllerTables.FIELDS}, device="cpu")
    own = TC.ControllerTables.from_table(port_table(jt), capacity=40,
                                         device="cpu")
    for f in TC.ControllerTables.FIELDS:
        assert torch.equal(getattr(conv, f), getattr(own, f)), f


def test_fleet_swap_tables_touches_only_the_lanes():
    tabs = [TC.ControllerTables.from_table(port_table(table_for(i)),
                                           capacity=48, device="cpu")
            for i in range(4)]
    stack = TC.stack_tables(tabs)
    fresh = TC.ControllerTables.from_table(port_table(table_for(9, 3)),
                                           capacity=48, device="cpu")
    out = TC.fleet_swap_tables(stack, [1, 3], TC.stack_tables([fresh, fresh]))
    for f in TC.ControllerTables.FIELDS:
        got, old, new = getattr(out, f), getattr(stack, f), getattr(fresh, f)
        assert torch.equal(got[0], old[0]) and torch.equal(got[2], old[2])
        assert torch.equal(got[1], new) and torch.equal(got[3], new)
    with pytest.raises(ValueError, match="capacity"):
        TC.fleet_swap_tables(stack, 0, TC.ControllerTables.from_table(
            port_table(table_for(0)), capacity=64, device="cpu"))
