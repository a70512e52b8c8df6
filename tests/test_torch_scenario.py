"""The port's scenario harness (``repro_torch.core.scenario``) against the
JAX package's and against the committed golden traces.

Every scenario runs on the CPU (``device="cpu"``).  A spec is built by one
function over either package's scenario module, so the same script runs
through both; the JAX side's tables are carried across with
``repro_torch.convert``.  Traces are compared as JSON, byte for byte; every
port run also holds the fleet tick and the drift monitor to one table
layout (``cache_size() == 1``).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.scenario as J  # noqa: E402
from benchmarks.common import synthetic_controller_table  # noqa: E402
from repro.core.characterization import characterize as jax_characterize  # noqa: E402
from repro.data.camera import CameraConfig, SyntheticCamera  # noqa: E402
import repro_torch.core.scenario as T  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis.trace_guard import assert_compiled_once  # noqa: E402
from repro_torch.core.characterization import characterize  # noqa: E402
from repro_torch.data.camera import CameraConfig as TCameraConfig  # noqa: E402
from repro_torch.data.camera import SyntheticCamera as TCamera  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def port_table(t):
    """A JAX-side CharacterizationTable carried across as NumPy arrays."""
    p = t.proxy
    return convert.table_from_numpy(
        settings=[dataclasses.astuple(s) for s in t.settings],
        sizes_sorted=t.sizes_sorted, best_acc=t.best_acc,
        best_idx=t.best_idx, acc_by_setting=t.acc_by_setting,
        size_by_setting=t.size_by_setting,
        proxy_coeffs=None if p is None else p.coeffs,
        proxy_median_rel_err=0.0 if p is None else p.median_rel_err,
        proxy_max_rel_err=0.0 if p is None else p.max_rel_err,
        min_accuracy=t.min_accuracy, source=t.source, activity=t.activity,
        residual_spread=t.residual_spread)


def run_port(spec, **kw):
    """``repro_torch``'s run_scenario on the CPU; every swap and retarget of
    the run must keep the fleet tick and the drift monitor on one layout."""
    res = T.run_scenario(spec, device="cpu", **kw)
    for label, size in (("fleet tick", res.fleet_cache_size),
                        ("drift monitor", res.drift_cache_size)):
        if size is not None:
            assert_compiled_once(size, label)
    return res


@pytest.fixture(scope="module")
def jax_complex():
    """tests/test_scenario.py's ``complex_table``: the paper's Section 5
    operating point."""
    return jax_characterize(
        lambda: SyntheticCamera(CameraConfig(dynamics="complex", seed=7)),
        clip_len=12, min_accuracy=0.95)


@pytest.fixture(scope="module")
def port_complex():
    """The same characterization by the port, on the CPU."""
    return characterize(
        lambda: TCamera(TCameraConfig(dynamics="complex", seed=7)),
        clip_len=12, min_accuracy=0.95, device="cpu")


# =============================================================================
# Specs, over either package's scenario module M
# =============================================================================


def claim_spec(M, *, controlled=True, fleet=False):
    """tests/test_scenario.py's paper-claim scenario: a 10x latency spike
    over the paper's 5-camera testbed."""
    return M.ScenarioSpec(
        name="paper-claim-10x",
        cameras=tuple(M.CameraSpec(f"cam{i}", dynamics="complex")
                      for i in range(5)),
        frames=60, seed=3, workload="jaad",
        latency=0.100, accuracy=0.95, min_accuracy=0.95,
        controlled=controlled, fleet=fleet, record_decisions=fleet,
        events=(M.InterferenceSpike(start=4.0, end=9.0, factor=10.0),))


def fig11_spec(M):
    return M.ScenarioSpec(
        name="golden-fig11-small",
        cameras=tuple(M.CameraSpec(f"cam{i}", dynamics="complex")
                      for i in range(3)),
        frames=24, seed=11, workload="jaad",
        latency=0.100, accuracy=0.92,
        events=(M.InterferenceSpike(start=2.0, end=3.5, factor=6.0),
                M.QosChange(at=4.0, latency=0.060)))


def tenant_flood_spec(M):
    return M.ScenarioSpec(
        name="tenant-flood",
        cameras=tuple(M.CameraSpec(f"cam{i}", dynamics="medium")
                      for i in range(2)),
        frames=20, seed=5, workload="jaad",
        latency=0.100, accuracy=0.92, wire_budget=1.65e7,
        events=(M.TenantJoin(at=0.5, tenant="acme", slo="gold"),
                M.TenantJoin(at=1.0, tenant="bulk", slo="best_effort"),
                M.TenantJoin(at=1.5, tenant="probe", slo="gold",
                             admission="reject"),
                M.TenantLeave(at=3.0, tenant="acme")))


def sceneshift_spec(M):
    """tests/test_drift.py's golden: cam1's scene turns complex at 2 s and
    the drift monitor re-sweeps its table from live frames."""
    return M.ScenarioSpec(
        name="golden-sceneshift-refresh",
        cameras=(M.CameraSpec("cam0", dynamics="simple"),
                 M.CameraSpec("cam1", dynamics="simple")),
        frames=30, seed=17, workload="jaad",
        latency=0.100, accuracy=0.95, min_accuracy=0.90,
        auto_recharacterize=True,
        events=(M.SceneShift(at=2.0, camera_id="cam1", dynamics="complex"),))


def synthetic(dynamics):
    return lambda: {dynamics: port_table(synthetic_controller_table())}


def sceneshift_tables():
    """Per-camera simple tables, characterized by the port on the CPU."""
    return {cid: characterize(
        lambda cid=cid: TCamera(TCameraConfig(camera_id=cid,
                                              dynamics="simple", seed=7)),
        clip_len=10, min_accuracy=0.90, device="cpu")
        for cid in ("cam0", "cam1")}


GOLDENS = {
    "scenario_fig11_small": (fig11_spec, synthetic("complex")),
    "scenario_tenant_flood": (tenant_flood_spec, synthetic("medium")),
    "scenario_sceneshift_refresh": (sceneshift_spec, sceneshift_tables),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_trace_reproduced(name):
    """The port writes each committed golden trace byte for byte (the
    sceneshift run through its own characterize and drift re-sweep)."""
    spec_fn, tables = GOLDENS[name]
    res = run_port(spec_fn(T), tables=tables())
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as fh:
        golden = fh.read()
    assert res.to_json(indent=1) + "\n" == golden
    if name == "scenario_sceneshift_refresh":
        assert any(e["kind"] == "table_refresh" and "re-swept" in e["detail"]
                   for e in res.events_log)


def test_characterize_matches_jax(jax_complex, port_complex):
    """The claim's table: the same kept settings with the same accuracies;
    sizes within ROADMAP Queue 3's 2e-3 (summation order of the sweep)."""
    assert [dataclasses.astuple(s) for s in port_complex.settings] == \
        [dataclasses.astuple(s) for s in jax_complex.settings]
    np.testing.assert_array_equal(port_complex.acc_by_setting,
                                  jax_complex.acc_by_setting)
    np.testing.assert_array_equal(port_complex.best_idx, jax_complex.best_idx)
    np.testing.assert_allclose(port_complex.size_by_setting,
                               jax_complex.size_by_setting, rtol=2e-3)


def delivered(res):
    return [(r.camera_id, r.timestamp, r.wire_bytes, r.knob_index)
            for r in res.rows]


@pytest.mark.parametrize("fleet", [False, True], ids=["host", "fleet"])
def test_claim_matches_jax(jax_complex, fleet):
    """The paper-claim run through both packages from one table: the same
    delivered (camera, timestamp, wire bytes, knob index) sequence, the
    same events and trace, the same credit ledger and frame cache."""
    jres = J.run_scenario(claim_spec(J, fleet=fleet),
                          tables={"complex": jax_complex})
    tres = run_port(claim_spec(T, fleet=fleet),
                    tables={"complex": port_table(jax_complex)})
    assert delivered(tres) == delivered(jres)
    assert tres.events_log == jres.events_log
    assert tres.to_json() == jres.to_json()
    assert tres.credit_stats == jres.credit_stats
    assert tres.cache_stats == jres.cache_stats
    assert tres.fleet_history == jres.fleet_history


def test_paper_claim_holds(port_complex):
    """tests/test_scenario.py's claim checks on the port's own table and
    fleet control plane: a 10x spike absorbed with at most 5% F1 drop."""
    tables = {"complex": port_complex}
    ctl = run_port(claim_spec(T, fleet=True), tables=tables)
    unc = run_port(claim_spec(T, controlled=False), tables=tables)
    unc_spike = unc.p95_latency_ms(5.0, 9.0)
    assert unc_spike / unc.p95_latency_ms(2.0, 4.0) > 8.0
    base_acc = ctl.mean_accuracy(2.0, 4.0)
    assert base_acc > 0
    assert 1.0 - ctl.mean_accuracy(4.5, 9.0) / base_acc <= 0.05
    assert ctl.min_accuracy(4.5, 9.0) >= 0.95
    assert ctl.p95_latency_ms(5.0, 9.0) <= 0.45 * unc_spike
    assert ctl.p95_latency_ms(9.5, 12.0) < 130.0
    assert not any(r.infeasible for r in ctl.rows)
    assert ctl.fleet_cache_size == 1


def test_claim_is_deterministic(port_complex):
    a = run_port(claim_spec(T), tables={"complex": port_complex})
    b = run_port(claim_spec(T), tables={"complex": port_complex})
    assert a.to_json() == b.to_json()


def test_fleet_plane_matches_host(port_complex):
    """The claim on the fused fleet tick reproduces the host path's trace
    byte for byte, on one table layout."""
    tables = {"complex": port_complex}
    host = run_port(claim_spec(T), tables=tables)
    flt = run_port(claim_spec(T, fleet=True), tables=tables)
    assert flt.to_json() == host.to_json()
    assert host.fleet_cache_size is None
    assert flt.fleet_cache_size == 1
    assert len(flt.fleet_history) > 0


def engine_spec(M, events, **kw):
    """tests/test_scenario.py's ``small_spec``: two medium cameras."""
    return M.ScenarioSpec(
        name="engine",
        cameras=tuple(M.CameraSpec(f"cam{i}", dynamics="medium")
                      for i in range(2)),
        frames=16, seed=5, workload="jaad",
        latency=0.100, accuracy=0.92, events=events(M), **kw)


ENGINE_EVENTS = {
    "camera_crash": lambda M: (M.CameraCrash(at=1.0, camera_id="cam0"),
                               M.CameraRecover(at=2.0, camera_id="cam0")),
    "edge_crash": lambda M: (M.EdgeCrash(at=1.2), M.EdgeRecover(at=2.0)),
    "congestion": lambda M: (M.CongestionRamp(start=1.0, end=2.0,
                                              peers=4),),
    "peer_churn": lambda M: (M.PeerJoin(at=1.0, node_id="forklift"),
                             M.PeerLeave(at=2.0, node_id="forklift")),
    "distance": lambda M: (M.DistanceDrift("cam0", start=0.0, end=1.0,
                                           to_m=40.0),),
    "qos_change": lambda M: (M.QosChange(at=1.5, latency=0.042),),
    "table_refresh": lambda M: (M.TableRefresh(at=1.5, camera_id="cam1"),),
    "staleness": lambda M: (M.TableStaleness(at=1.0, camera_id="cam0",
                                             factor=0.5),),
}


@pytest.mark.parametrize("fleet", [False, True], ids=["host", "fleet"])
@pytest.mark.parametrize("kind", sorted(ENGINE_EVENTS))
def test_scripted_events_match_jax(kind, fleet):
    """Every kind of scripted event, on the host path and the fleet tick,
    gives the JAX package's trace, ledger and drift fires (the staleness
    case with the drift monitor armed, so it re-sweeps live)."""
    kw = dict(fleet=fleet, auto_recharacterize=kind == "staleness")
    jres = J.run_scenario(engine_spec(J, ENGINE_EVENTS[kind], **kw),
                          tables={"medium": synthetic_controller_table()})
    tres = run_port(engine_spec(T, ENGINE_EVENTS[kind], **kw),
                    tables=synthetic("medium")())
    assert tres.to_json() == jres.to_json()
    assert tres.credit_stats == jres.credit_stats
    assert tres.drift_fire_counts == jres.drift_fire_counts
    assert len(tres.rows) == 32


def test_mesh_is_refused():
    """A mesh is no longer refused: the fig11 golden with its fleet tick
    split four ways on the CPU traces byte for byte like the unmeshed
    fleet run; a mesh without the fleet tick raises."""
    tables = synthetic("complex")()
    flat = run_port(dataclasses.replace(fig11_spec(T), fleet=True),
                    tables=tables)
    meshed = run_port(dataclasses.replace(fig11_spec(T), fleet=True,
                                          mesh=["cpu"] * 4), tables=tables)
    assert meshed.to_json() == flat.to_json()
    assert meshed.fleet_cache_size == 1
    with pytest.raises(ValueError, match="requires fleet=True"):
        T.run_scenario(dataclasses.replace(fig11_spec(T), mesh=["cpu"] * 4),
                       tables=tables, device="cpu")
