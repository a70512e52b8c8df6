"""The port's federated broker tier (``repro_torch.core.federation``):
herd parity with a lone broker, exactly-once live migration, the herd-wide
credit ledger, and a federated scenario of the gauntlet's shape through
both packages.

Everything runs on the CPU (``device="cpu"``); the tables are the JAX
suite's synthetic table carried across with ``repro_torch.convert``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.scenario as J  # noqa: E402
from benchmarks.common import synthetic_controller_table  # noqa: E402
import repro_torch.core.scenario as T  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.api import (EventKind, QosBounds, RPCTimeout,  # noqa: E402
                                  SubscriptionOptions)
from repro_torch.core.broker import CamBroker, MezSystem  # noqa: E402
from repro_torch.core.channel import (ChannelConfig, WirelessChannel,  # noqa: E402
                                      calibrated_channel)
from repro_torch.core.characterization import fit_latency_regression  # noqa: E402
from repro_torch.core.federation import FederatedMezSystem  # noqa: E402
from repro_torch.core.session import MezClient  # noqa: E402
from repro_torch.data.camera import CameraConfig, SyntheticCamera  # noqa: E402

SLO_CYCLE = ("best_effort", "silver", "gold")


def port_table(t):
    """A JAX-side CharacterizationTable carried across as NumPy arrays."""
    return convert.table_from_numpy(
        settings=[dataclasses.astuple(s) for s in t.settings],
        sizes_sorted=t.sizes_sorted, best_acc=t.best_acc,
        best_idx=t.best_idx, acc_by_setting=t.acc_by_setting,
        size_by_setting=t.size_by_setting, min_accuracy=t.min_accuracy,
        source=t.source, activity=t.activity,
        residual_spread=t.residual_spread)


@pytest.fixture(scope="module")
def table():
    return port_table(synthetic_controller_table())


def wire(system, table, *, n_cams, frames, **add):
    """Cameras with published medium streams, set to (100 ms, 0.90);
    returns {camera_id: [published timestamps]}."""
    ch = system.channel
    sizes = np.linspace(table.sizes_sorted[0], table.sizes_sorted[-1], 12)
    reg = fit_latency_regression(sizes, ch.regression_points(sizes, n=n_cams))
    published = {}
    for i in range(n_cams):
        cam = system.add_camera(f"cam{i}", **add)
        src = SyntheticCamera(CameraConfig(camera_id=f"cam{i}",
                                           dynamics="medium", seed=7))
        cam.background = src.background
        cam.set_target(0.100, 0.90, table, reg)
        published[f"cam{i}"] = []
        for ts, f, _ in src.stream(frames):
            cam.publish(ts, f)
            published[f"cam{i}"].append(float(ts))
    return published


def build_federated(table, *, n_cams=3, frames=10, n_brokers=2, seed=3,
                    jitter=True):
    """tests/test_federation.py's herd, on the CPU.  ``jitter=False``
    zeroes the channel's jitter so decisions do not depend on fetch order
    across brokers."""
    ch = (calibrated_channel(seed=seed) if jitter else
          WirelessChannel(ChannelConfig(jitter_sigma=0.0), seed=seed))
    system = FederatedMezSystem(ch, n_brokers=n_brokers, device="cpu")
    return system, wire(system, table, n_cams=n_cams, frames=frames)


def drain(sub, *, max_frames=6, hook=None):
    """Poll to exhaustion: ({camera_id: [timestamps]}, delivered frames);
    ``hook(poll_index)`` runs after each non-empty poll."""
    seen, rows = {}, []
    for i in range(200):
        batch = sub.poll(max_frames=max_frames)
        if not batch:
            break
        for d in batch.frames:
            seen.setdefault(d.camera_id, []).append(float(d.timestamp))
            rows.append(d)
        if hook is not None:
            hook(i)
    return seen, rows


def assert_exactly_once(seen, published):
    assert set(seen) == set(published)
    for cid, stamps in published.items():
        assert seen[cid] == stamps, cid


def assert_conserved(herd):
    rep = herd.credit_report()
    assert rep["leaked"] == 0 and rep["in_flight"] == 0, rep


def test_single_broker_herd_matches_mezsystem(table):
    """A one-broker herd is byte-identical to a lone ``MezSystem``."""
    def run(system):
        sess = MezClient(system).open_session("app")
        sub = sess.subscribe(["cam0", "cam1"], 0.0, 100.0,
                             qos=QosBounds(0.1, 0.9))
        _, rows = drain(sub)
        sess.close()
        return [(d.camera_id, d.timestamp, d.knob_index, d.wire_bytes,
                 d.latency.total) for d in rows]

    herd, _ = build_federated(table, n_cams=2, frames=8, n_brokers=1)
    lone = MezSystem(calibrated_channel(seed=3), device="cpu")
    wire(lone, table, n_cams=2, frames=8)
    assert run(herd) == run(lone)


def test_exactly_once_across_migration(table):
    """A mid-stream migration loses no frame and duplicates none; the
    subscriber sees one CAMERA_MIGRATED event under the herd subscription
    id, and the ledger conserves herd-wide."""
    system, published = build_federated(table, n_cams=3, frames=12)
    herd = system.herd
    sess = MezClient(system).open_session("app")
    sub = sess.subscribe(["cam0", "cam1", "cam2"], 0.0, 100.0,
                         qos=QosBounds(0.1, 0.9))

    def hook(i):
        if i == 1:
            assert herd.migrate_camera("cam0", 1, at=1.0)

    seen, _ = drain(sub, hook=hook)
    assert_exactly_once(seen, published)
    assert herd.route_of("cam0") == 1 and herd.migrations == 1
    assert_conserved(herd)
    (ev,) = [e for e in sess.events() if e.kind is EventKind.CAMERA_MIGRATED]
    assert ev.camera_id == "cam0"
    assert ev.subscription_id == sub.subscription_id
    assert "0 -> 1" in ev.detail
    sess.close()


@pytest.mark.parametrize("fleet", [False, True], ids=["host", "fleet"])
def test_migration_is_invisible_in_decisions(table, fleet):
    """With order-independent latencies the migrated lane decides exactly
    as without the migration: the PI state (a fleet lane's on the device
    included) travels with the camera.  On the host path the host
    controllers own that state and must end equal too; on the fleet tick
    the lanes own it, and each part's tick stays on one table layout."""
    def run(migrate):
        system, published = build_federated(table, n_cams=3, frames=12,
                                            jitter=False)
        herd = system.herd
        sess = MezClient(system).open_session("app")
        sub = sess.subscribe(["cam0", "cam1", "cam2"], 0.0, 100.0,
                             qos=QosBounds(0.1, 0.9),
                             options=SubscriptionOptions(fleet=fleet))

        def hook(i):
            if migrate and i == 1:
                assert herd.migrate_camera("cam0", 1, at=1.0)

        seen, rows = drain(sub, hook=hook)
        assert_exactly_once(seen, published)
        if fleet:
            for part in herd._subs[sub.subscription_id].parts:
                fc = herd.brokers[part.broker].subscription_fleet(part.sub_id)
                assert fc.cache_size() == 1
        trace = sorted((d.camera_id, float(d.timestamp), int(d.knob_index),
                        int(d.wire_bytes), float(d.latency.total))
                       for d in rows)
        integrals = (None if fleet else
                     {c: system.cams[c].controller.integral
                      for c in published})
        sess.close()
        return trace, integrals

    assert run(migrate=True) == run(migrate=False)


def test_herd_refuses_a_camera_on_another_device(table):
    system = FederatedMezSystem(calibrated_channel(seed=3), device="cpu")
    cam = CamBroker("cam9", system.channel, device="meta")
    with pytest.raises(ValueError, match="herd on cpu"):
        system.herd.register(cam)


# tests/test_federation.py's adversarial interleavings: (op, a, b)
INTERLEAVINGS = {
    "crash-during-migration": [
        ("crash", 1, 0), ("migrate", 0, 1), ("recover", 1, 0),
        ("migrate", 0, 1), ("poll", 0, 0)],
    "migrate-during-poll": [
        ("poll", 0, 0), ("migrate", 0, 1), ("poll", 0, 0), ("migrate", 0, 0),
        ("poll", 0, 0), ("migrate", 2, 1), ("poll", 0, 0)],
    "whole-herd-outage": [
        ("poll", 0, 0), ("crash", 0, 0), ("crash", 1, 0), ("poll", 0, 0),
        ("migrate", 1, 0), ("recover", 0, 0), ("migrate", 1, 0),
        ("poll", 0, 0), ("recover", 1, 0)],
}


@pytest.mark.parametrize("name", sorted(INTERLEAVINGS))
def test_credit_ledger_conserved_herd_wide(table, name):
    """After every poll, migration, crash and recovery the herd-wide
    ledger conserves and no frame arrives twice; once the herd is back and
    drained, every frame arrived exactly once."""
    system, published = build_federated(table, n_cams=3, frames=6)
    herd = system.herd
    sess = MezClient(system).open_session("app")
    sub = sess.subscribe(["cam0", "cam1", "cam2"], 0.0, 100.0,
                         qos=QosBounds(0.1, 0.9))
    seen = {c: [] for c in published}
    for op, a, b in INTERLEAVINGS[name]:
        if op == "poll":
            try:
                for d in sub.poll(max_frames=5).frames:
                    seen[d.camera_id].append(float(d.timestamp))
            except RPCTimeout:
                pass
        elif op == "migrate":
            try:
                herd.migrate_camera(f"cam{a}", b)
            except RPCTimeout:
                pass
        elif op == "crash":
            herd.crash(broker=a)
        else:
            herd.recover(broker=a)
        assert_conserved(herd)
        for cid, stamps in seen.items():
            assert len(stamps) == len(set(stamps)), cid
    herd.recover()
    while (batch := sub.poll(max_frames=5)):
        for d in batch.frames:
            seen[d.camera_id].append(float(d.timestamp))
    assert_exactly_once(seen, published)
    assert_conserved(herd)
    sess.close()


def federated_spec(M, frames):
    """benchmarks/gauntlet.py's ``federated`` phase: two brokers, 8
    SLO-classed tenants, two live migrations, a degraded backhaul and a
    rolling upgrade."""
    t_end = frames / 5.0
    events = [M.TenantJoin(at=round(0.2 + 0.1 * i, 3), tenant=f"f{i}",
                           slo=SLO_CYCLE[i % 3]) for i in range(8)]
    events += [
        M.CameraMigrate(at=round(t_end * 0.25, 3), camera_id="cam0",
                        to_broker=1),
        M.CameraMigrate(at=round(t_end * 0.35, 3), camera_id="cam3",
                        to_broker=0),
        M.BrokerOverload(at=round(t_end * 0.5, 3), broker=0, factor=0.5),
        M.RollingUpgrade(at=round(t_end * 0.7, 3))]
    return M.ScenarioSpec(
        name="gauntlet-federated",
        cameras=tuple(M.CameraSpec(f"cam{i}", dynamics="medium", fps=5.0)
                      for i in range(4)),
        frames=frames, seed=11, workload="jaad", latency=0.100,
        accuracy=0.92, n_brokers=2,
        events=tuple(sorted(events, key=lambda e: e.at)))


def check_federated(frames):
    jres = J.run_scenario(federated_spec(J, frames),
                          tables={"medium": synthetic_controller_table()})
    tres = T.run_scenario(federated_spec(T, frames),
                          tables={"medium": port_table(
                              synthetic_controller_table())}, device="cpu")
    assert tres.to_json() == jres.to_json()
    assert tres.tenant_latencies == jres.tenant_latencies
    assert tres.credit_stats == jres.credit_stats
    assert tres.cache_stats == jres.cache_stats
    assert tres.credit_stats["leaked"] == 0
    assert tres.credit_stats["in_flight"] == 0
    assert len(tres.rows) == 4 * frames
    kinds = {e["kind"] for e in tres.events_log}
    assert {"CameraMigrate", "BrokerOverload", "RollingUpgrade",
            "camera_migrated"} <= kinds


def test_federated_scenario_matches_jax():
    """The gauntlet's federated shape at its quick length (60 frames a
    camera) gives the JAX package's trace, tenant latencies, ledger and
    cache counters; every frame is delivered and no credit leaks."""
    check_federated(60)


@pytest.mark.slow
def test_federated_soak_matches_jax():
    """The same at the gauntlet's full length (120 frames a camera), the
    length tests/test_gauntlet.py's slow soak runs."""
    check_federated(120)


def test_federated_events_require_n_brokers(table):
    spec = dataclasses.replace(federated_spec(T, 16), n_brokers=1)
    with pytest.raises(TypeError, match="n_brokers"):
        T.run_scenario(spec, tables={"medium": table}, device="cpu")
