"""The fleet tick split over a ``cams`` mesh (``repro_torch.sharding.
partition.fleet_mesh`` / ``shard_fleet_tick`` under ``FleetController(
mesh=...)``), on the CPU.

The port's counterpart of ``tests/test_fleet_sharded.py``'s child script,
run in process on ``fleet_mesh(["cpu"] * 8)`` (the JAX test forces eight
host devices; a device sequence with repeats is the port's way): 13
cameras padded to 16 lanes through subset table swaps and retargets, every
decision equal to a host ``LatencyController``'s, one table layout
throughout (``cache_size() == 1``); the scenario of that test (an
InterferenceSpike over three medium cameras) meshed, its trace byte-equal
to the unmeshed port runs and to the JAX package's; a drift monitor fused
into a meshed tick (its padding lanes sliced off by ``absorb_fused``)
firing as off the mesh.  Also the chunk layout, the equality of the split tick with the
whole one lane by lane, writes that touch only the owner chunk, and the
refusals: ``fleet_mesh(k)`` without ``k`` CUDA devices and a mesh without
``fleet=True``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.scenario as J  # noqa: E402
from benchmarks.common import synthetic_controller_table  # noqa: E402
import repro_torch.core.scenario as T  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api as TA  # noqa: E402
from repro_torch.core.broker import MezSystem  # noqa: E402
from repro_torch.core.channel import calibrated_channel  # noqa: E402
from repro_torch.core.characterization import LatencyRegression  # noqa: E402
from repro_torch.core.controller import (ControllerConfig,  # noqa: E402
                                         ControllerParams, ControllerTables,
                                         FleetController, LatencyController,
                                         fleet_controller_init,
                                         fused_fleet_tick, stack_params,
                                         stack_tables)
from repro_torch.core.drift import (DriftConfig, DriftMonitor,  # noqa: E402
                                    DriftParams, drift_init)
from repro_torch.sharding.partition import (FleetMesh, LaneChunks,  # noqa: E402
                                            fleet_mesh, fleet_sharding,
                                            padded_lane_count, rec_map,
                                            shard_fleet_tick)

MESH = ["cpu"] * 8


def port_table(t):
    """A JAX-side synthetic table carried across as NumPy arrays."""
    return convert.table_from_numpy(
        settings=[dataclasses.astuple(s) for s in t.settings],
        sizes_sorted=t.sizes_sorted, best_acc=t.best_acc,
        best_idx=t.best_idx, acc_by_setting=t.acc_by_setting,
        size_by_setting=t.size_by_setting, proxy_coeffs=None,
        proxy_median_rel_err=0.0, proxy_max_rel_err=0.0,
        min_accuracy=t.min_accuracy, source=t.source, activity=t.activity,
        residual_spread=t.residual_spread)


def table(n=24, smin=2e3, smax=9e4):
    return port_table(synthetic_controller_table(n, smin=smin, smax=smax))


class _Cam:
    def __init__(self, cid, ctrl):
        self.camera_id, self.controller = cid, ctrl
        self.table_version = self.qos_version = 0


def thirteen_cams():
    """tests/test_fleet_sharded.py's 13 cameras, each with a twin host
    controller."""
    reg = LatencyRegression(slope=1.2e-6, intercept=0.008)
    cams, hosts = [], []
    for i in range(13):
        tbl = table(12 + i % 29, smin=2e3 + 37.0 * i, smax=9e4 - 101.0 * i)
        cfg = ControllerConfig(latency_target=0.040 + 0.001 * (i % 17),
                               accuracy_target=0.90 + 0.002 * (i % 4))
        cams.append(_Cam(f"cam{i:03d}", LatencyController(cfg, tbl, reg)))
        hosts.append(LatencyController(cfg, tbl, reg))
    return cams, hosts


def test_thirteen_cams_on_eight_devices_match_host_controllers():
    mesh = fleet_mesh(MESH)
    assert padded_lane_count(13, mesh) == 16
    cams, hosts = thirteen_cams()
    fleet = FleetController(cams, capacity=128, mesh=mesh)
    assert fleet._n_padded == 16 and fleet.device == torch.device("cpu")
    rng = np.random.default_rng(0)
    for step in range(36):
        if step == 10:
            for i in (2, 7, 12):
                fresh = table(20 + i, smin=3e3 + 11.0 * i, smax=7e4)
                cams[i].controller.swap_table(fresh)
                cams[i].table_version += 1
                hosts[i].swap_table(fresh)
        if step == 22:
            for i in (0, 5):
                cams[i].controller.set_target(0.075, 0.91)
                cams[i].qos_version += 1
                hosts[i].set_target(0.075, 0.91)
        fb = {c.camera_id: float(rng.uniform(0.005, 0.5)) for c in cams}
        decisions = fleet.decide(fb)
        for i, cam in enumerate(cams):
            dh = hosts[i].update(fb[cam.camera_id])
            df = decisions[cam.camera_id]
            assert df.setting_index == dh.setting_index, (step, i)
            assert df.acted == dh.acted, (step, i)
            assert df.feasible == dh.feasible, (step, i)
    assert fleet.cache_size() == 1, fleet.cache_size()
    assert isinstance(fleet.state, LaneChunks)
    assert [p.integral.shape[0] for p in fleet.state.parts] == [2] * 8
    for i, cam in enumerate(cams):
        assert fleet.export_lane(cam.camera_id) == (
            pytest.approx(hosts[i].integral, abs=1e-6), hosts[i]._current)


def parity_spec(M, **kw):
    """tests/test_fleet_sharded.py's scenario."""
    base = dict(
        name="fleet-sharded-parity",
        cameras=tuple(M.CameraSpec(f"cam{i}", dynamics="medium")
                      for i in range(3)),
        frames=30, seed=9, workload="jaad",
        latency=0.100, accuracy=0.92,
        events=(M.InterferenceSpike(start=2.0, end=4.0, factor=7.0),))
    base.update(kw)
    return M.ScenarioSpec(**base)


def test_meshed_scenario_matches_unmeshed_and_jax():
    tables = {"medium": table()}
    meshed = T.run_scenario(parity_spec(T, fleet=True, mesh=MESH),
                            tables=tables, device="cpu")
    host = T.run_scenario(parity_spec(T, fleet=False), tables=tables,
                          device="cpu")
    fleet = T.run_scenario(parity_spec(T, fleet=True), tables=tables,
                           device="cpu")
    jres = J.run_scenario(parity_spec(J, fleet=False),
                          tables={"medium": synthetic_controller_table()})
    assert meshed.to_json() == host.to_json() == fleet.to_json()
    assert meshed.to_json() == jres.to_json()
    assert meshed.fleet_cache_size == 1


def test_fused_drift_on_a_mesh_matches_the_unmeshed_fleet():
    """Five drift lanes fused into a tick split four ways (three padding
    lanes) through 24 ticks of residuals that drive some lanes past
    ``hi`` and back under ``lo``: the same decisions, fires, scores and
    fire counts as the unmeshed fleet, the monitor's state kept in
    chunks with only the real lanes marked (``absorb_fused``)."""
    cfg = DriftConfig(window=4, hi=0.35, lo=0.15, min_samples=2)

    def run(mesh):
        cams, _ = thirteen_cams()
        cams = cams[:5]
        mon = DriftMonitor([c.camera_id for c in cams], cfg, device="cpu")
        fleet = FleetController(cams, capacity=64, mesh=mesh, device="cpu")
        fleet.attach_drift(mon)
        rng = np.random.default_rng(5)
        out = []
        for step in range(24):
            lat = rng.uniform(0.005, 0.3, 5).astype(np.float32)
            errs = np.where(np.arange(5) % 2 == (step // 8) % 2,
                            rng.uniform(0.4, 0.9, 5),
                            rng.uniform(0.0, 0.1, 5)).astype(np.float32)
            res = fleet.tick(lat, np.ones(5, bool), errs, np.ones(5, bool))
            out.append(([(d.setting_index, d.acted, d.feasible)
                         for d in res.values()], res.fired_cams,
                        dict(mon.last_scores)))
        return out, mon.fire_counts(), mon, fleet

    meshed, fires, mon, fleet = run(["cpu"] * 4)
    flat, flat_fires, _, _ = run(None)
    assert meshed == flat and fires == flat_fires
    assert sum(fires.values()) > 0
    assert isinstance(mon.state, LaneChunks)
    assert mon.state.n_lanes == 5 and mon.state.n_padded == 8
    assert fleet.cache_size() == mon.cache_size() == 1


def _operands(n, rng):
    cams, _ = thirteen_cams()
    cams = (cams * 2)[:n]
    tables = stack_tables([ControllerTables.from_table(
        c.controller.table, capacity=64, device="cpu") for c in cams])
    params = stack_params([ControllerParams.from_controller(
        c.controller, device="cpu") for c in cams])
    state = fleet_controller_init(tables)
    dstate = drift_init(n, 4, device="cpu")
    dparams = DriftParams.from_config(DriftConfig(window=4, min_samples=1),
                                      n, device="cpu")
    lat = rng.uniform(0.005, 0.3, n).astype(np.float32)
    errs = rng.uniform(0.0, 2.0, n).astype(np.float32)
    valid = rng.uniform(size=n) < 0.7
    return (state, dstate, torch.from_numpy(lat), torch.from_numpy(errs),
            torch.from_numpy(valid), tables, params, dparams)


def test_split_tick_equals_the_whole_tick_lane_by_lane():
    rng = np.random.default_rng(3)
    ops = _operands(16, rng)
    mesh = fleet_mesh(["cpu"] * 4)
    tick = shard_fleet_tick(fused_fleet_tick, mesh)
    want = fused_fleet_tick(*ops)
    got = tick(*ops)
    assert len(got) == 3 and all(isinstance(g, LaneChunks) for g in got)
    assert [g.n_padded for g in got] == [16] * 3
    for g, w in zip(got, want):
        rec_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0,
                                                        atol=0),
                g.gather("cpu"), w)
    # chunks fed back as operands stay where they are
    again = tick(got[0], got[1], *ops[2:])
    assert again[0].parts[1].integral.device == torch.device("cpu")
    with pytest.raises(TypeError, match="8 operands"):
        tick(*ops[:7])
    with pytest.raises(ValueError, match="do not split"):
        shard_fleet_tick(fused_fleet_tick, fleet_mesh(["cpu"] * 3))(*ops)


def test_chunk_layout_and_owner_writes():
    mesh = fleet_mesh(["cpu"] * 4)
    sh = fleet_sharding(mesh)
    assert sh.bounds(12) == [(0, 3), (3, 6), (6, 9), (9, 12)]
    assert sh.owner(7, 12) == (2, 1)
    cams, hosts = thirteen_cams()
    fleet = FleetController(cams[:6], capacity=64, mesh=mesh)
    assert fleet._n_padded == 8
    before = [p.sizes_sorted for p in fleet.tables.parts]
    cams[5].controller.swap_table(table(30))
    cams[5].table_version += 1
    swapped, retargeted = fleet.sync()
    assert (swapped, retargeted) == ([5], [])
    after = [p.sizes_sorted for p in fleet.tables.parts]
    # lane 5 lives in chunk 2 (lanes 4-5): only that chunk was rewritten
    assert [a is b for a, b in zip(after, before)] == [True, True, False,
                                                       True]
    assert int(fleet.tables.parts[2].n_valid[1]) == 30
    fleet.set_budget_scale(0.5)
    assert all(float(p.budget_scale.max()) == 0.5
               for p in fleet.params.parts)


def test_split_copies_only_each_devices_own_lanes():
    """Each run of consecutive chunks on one device holds one copy of its
    own lanes there (the chunks are views of it), and no other lanes:
    on (meta, meta, cpu, cpu, meta, meta) the two meta runs are separate
    copies of lanes 0-3 and 8-11."""
    devs = [torch.device(d) for d in ("meta", "meta", "cpu", "cpu",
                                      "meta", "meta")]
    sh = fleet_sharding(FleetMesh(tuple(devs)))
    assert sh.runs() == [(devs[0], 0, 2), (devs[2], 2, 4), (devs[4], 4, 6)]
    state = drift_init(12, 3, device="cpu")
    state.errs.copy_(torch.arange(36.0).reshape(12, 3))
    chunks = sh.split(state)
    parts = [p.errs for p in chunks.parts]
    assert [p.device for p in parts] == devs
    assert all(p.shape == (2, 3) for p in parts)
    for first in (0, 4):
        a, b = parts[first], parts[first + 1]
        assert a.untyped_storage().nbytes() == 4 * 3 * 4
        assert b.untyped_storage().nbytes() == 4 * 3 * 4
        assert (a.storage_offset(), b.storage_offset()) == (0, 6)
        assert chunks.parts[first].fires.untyped_storage().nbytes() == 4 * 4
    assert torch.equal(parts[2], state.errs[4:6])
    assert torch.equal(parts[3], state.errs[6:8])


def test_absorb_fused_drops_padding_lanes():
    mon = DriftMonitor(["a", "b", "c"], DriftConfig(window=4), device="cpu")
    padded = drift_init(4, 4, device="cpu")
    padded.fires[3] = 7
    fired = mon.absorb_fused(padded, np.array([True, False, True, True]),
                             np.array([1.0, 2.0, 3.0, 9.0], np.float32))
    assert fired == ["a", "c"]
    assert mon.state.pos.shape == (3,)
    assert mon.fire_counts() == {"a": 0, "b": 0, "c": 0}
    assert mon.last_scores == {"a": 1.0, "b": 2.0, "c": 3.0}
    chunks = fleet_sharding(fleet_mesh(["cpu"] * 2)).split(padded)
    mon.absorb_fused(chunks, np.zeros(4, bool), np.zeros(4, np.float32))
    assert isinstance(mon.state, LaneChunks) and mon.state.n_lanes == 3
    assert mon.fire_counts() == {"a": 0, "b": 0, "c": 0}
    # observe() takes the whole state back off the chunks
    mon.observe({"a": 0.5})
    assert mon.state.pos.tolist() == [1, 0, 0]


def test_fleet_mesh_forms_and_refusals():
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="wants 2 CUDA devices"):
            fleet_mesh(2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet_mesh()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fleet_mesh(["cuda"])
    m = fleet_mesh(["cpu", "cpu"])
    assert fleet_mesh(m) is m and m.shape == {"cams": 2}
    with pytest.raises(ValueError, match="'cams' axis"):
        fleet_mesh(FleetMesh((torch.device("cpu"),), ("lanes",)))
    with pytest.raises(ValueError, match="empty"):
        fleet_mesh([])
    assert padded_lane_count(13, None) == 13
    assert padded_lane_count(16, m) == 16


def test_subscription_mesh_requires_fleet():
    system = MezSystem(calibrated_channel(seed=0), device="cpu")
    system.add_camera("cam0")
    sess = system.edge.open_session("app")
    spec = TA.SubscribeSpec("app", "cam0", 0.0, 1.0, 0.1, 0.9)
    with pytest.raises(ValueError, match="requires fleet=True"):
        system.edge.create_subscription(
            sess, (spec,), options=TA.SubscriptionOptions(mesh=MESH))
