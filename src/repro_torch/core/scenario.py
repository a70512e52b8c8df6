"""Declarative, seeded scenario DSL + trace-driven closed-loop harness.

The paper's headline result -- tolerating up to 10x latency variation with a
worst-case normalized-F1 drop of 4.2% (Section 6) -- and the broker-
benchmarking literature's lesson that edge-messaging claims only hold up
under systematic multi-scenario stress both want the same thing: scripted,
bit-reproducible experiments over the REAL system, not ad-hoc loops.  This
module provides that:

  * ``ScenarioSpec`` declares a fleet of synthetic cameras, shared QoS
    bounds, and a timeline of ``events`` over a VIRTUAL clock (stream
    seconds: frame N of a 5 fps camera carries timestamp N/5).
  * Events script ``WirelessChannel`` dynamics -- interference spikes,
    congestion ramps (phantom transmitters joining the collision domain),
    per-camera distance drift, peer churn -- and component faults: camera
    crash -> recover, edge-broker crash -> recover, live QoS renegotiation
    with optional online re-characterization.
  * ``run_scenario`` drives a full v2 ``Session`` closed loop (optionally on
    the fleet control plane: all cameras per poll in ONE fused controller
    tick on the device) and emits a per-frame trace: latency breakdown
    total, wire bytes, knob index, table-predicted normalized F1,
    infeasibility.  It runs on ``device`` (default ``"cuda"``): the
    characterization sweep and every live re-sweep go through the
    ``frame_knob_grid`` kernel there, and the fleet tick runs there once
    per poll.

Everything is deterministic given the spec's seed, which makes scenario
traces committable golden files: ``ScenarioResult.compact()`` is a stable
JSON shape asserted bit-for-bit in CI (tests/golden/).

Example -- the paper-claim scenario (10x latency inflation absorbed):

    spec = ScenarioSpec(
        name="latency-10x",
        cameras=tuple(CameraSpec(f"cam{i}") for i in range(5)),
        frames=60, latency=0.100, accuracy=0.95,
        events=(InterferenceSpike(start=4.0, end=9.0, factor=10.0),),
    )
    result = run_scenario(spec)            # on the card; device="cpu" asks
    drop = 1 - result.mean_accuracy(4.0, 9.0) / result.mean_accuracy(2.0, 4.0)
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import detector as det
from repro_torch.core.api import (AdmissionRejected, QosBounds, RPCTimeout,
                                  SubscriptionOptions, resolve_slo)
from repro_torch.core.broker import MESH_NOT_PORTED, MezSystem
from repro_torch.core.channel import calibrated_channel
from repro_torch.core.federation import FederatedMezSystem
from repro_torch.core.characterization import (CharacterizationTable,
                                               characterize,
                                               fit_latency_regression)
from repro_torch.core.drift import DriftConfig
from repro_torch.core.session import MezClient
from repro_torch.data.camera import CameraConfig, SyntheticCamera
from repro_torch.device import resolve_device

__all__ = [
    "CameraSpec", "ScenarioSpec", "ScenarioResult", "TraceRow",
    "InterferenceSpike", "CongestionRamp", "DistanceDrift",
    "PeerJoin", "PeerLeave", "CameraCrash", "CameraRecover",
    "EdgeCrash", "EdgeRecover", "QosChange", "TableRefresh",
    "SceneShift", "TableStaleness", "TenantJoin", "TenantLeave",
    "CameraMigrate", "BrokerOverload", "RollingUpgrade",
    "run_scenario",
]


# =============================================================================
# The DSL: camera fleet + timeline events
# =============================================================================


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """One synthetic IoT camera node of the scenario fleet."""
    camera_id: str
    dynamics: str = "complex"          # simple | medium | complex
    distance_m: float = 6.0
    fps: float = 5.0
    seed: int = 7


# -- continuous (windowed) channel dynamics -----------------------------------


@dataclasses.dataclass(frozen=True)
class InterferenceSpike:
    """External interference multiplying channel latency by ``factor`` over
    [start, end) of virtual time (paper Section 2.2's microwave-oven
    experiment, scripted).  Overlapping spikes compound multiplicatively."""
    start: float
    end: float
    factor: float

    def factor_at(self, t: float) -> float:
        return self.factor if self.start <= t < self.end else 1.0


@dataclasses.dataclass(frozen=True)
class CongestionRamp:
    """``peers`` phantom transmitters join the collision domain linearly
    over [start, end) and stay until ``leave_at`` (None = forever): CSMA/CA
    contention grows super-linearly with active transmitters (Table 1)."""
    start: float
    end: float
    peers: int
    leave_at: float | None = None

    def peers_at(self, t: float) -> int:
        if t < self.start:
            return 0
        if self.leave_at is not None and t >= self.leave_at:
            return 0
        if t >= self.end:
            return self.peers
        span = max(self.end - self.start, 1e-9)
        return int(self.peers * (t - self.start) / span)


@dataclasses.dataclass(frozen=True)
class DistanceDrift:
    """One camera drifts linearly from its spec distance to ``to_m`` over
    [start, end) (Table 2's 6 m -> 12 m effect, scripted as motion)."""
    camera_id: str
    start: float
    end: float
    to_m: float

    def distance_at(self, t: float, from_m: float) -> float:
        if t < self.start:
            return from_m
        if t >= self.end:
            return self.to_m
        frac = (t - self.start) / max(self.end - self.start, 1e-9)
        return from_m + (self.to_m - from_m) * frac


# -- one-shot events ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PeerJoin:
    """A foreign transmitter (not one of our cameras) joins the channel."""
    at: float
    node_id: str


@dataclasses.dataclass(frozen=True)
class PeerLeave:
    at: float
    node_id: str


@dataclasses.dataclass(frozen=True)
class CameraCrash:
    """IoT camera node fault (paper Section 4.4): RPCs time out, the
    subscription marks the camera failed and keeps streaming the rest."""
    at: float
    camera_id: str


@dataclasses.dataclass(frozen=True)
class CameraRecover:
    """Node reboot + re-attach: the cursor resumes where it stopped and
    frames published during the outage are delivered late, not lost."""
    at: float
    camera_id: str


@dataclasses.dataclass(frozen=True)
class EdgeCrash:
    """Edge-broker fault: every poll times out until recovery.

    With ``broker`` set (federated scenarios, ``n_brokers > 1``) only that
    broker of the herd goes down: its cameras' parts time out while the
    rest of the herd keeps serving -- partial availability is the point of
    federation."""
    at: float
    broker: int | None = None


@dataclasses.dataclass(frozen=True)
class EdgeRecover:
    at: float
    broker: int | None = None


@dataclasses.dataclass(frozen=True)
class QosChange:
    """Live renegotiation mid-scenario (``Subscription.update_qos``), with
    optional online re-characterization of every camera's knob tables."""
    at: float
    latency: float | None = None
    accuracy: float | None = None
    recharacterize: bool = False


@dataclasses.dataclass(frozen=True)
class TableRefresh:
    """Online re-sweep of ONE camera's knob tables from its own recent
    frames (``CamBroker.recharacterize``); a fleet-backed subscription
    hot-swaps the refreshed lane into its fused tick, no layout change."""
    at: float
    camera_id: str


@dataclasses.dataclass(frozen=True)
class SceneShift:
    """Workload shift: ONE camera's scene dynamics regime changes
    mid-stream (e.g. ``simple`` -> ``complex`` movers).  The background and
    the frame clock carry over -- only the mover population re-rolls
    (``SyntheticCamera.set_dynamics``) -- so the camera's installed
    characterization tables silently go stale: frames from the new regime
    deflate-compress differently from the calibration clip, which is the
    signal the drift monitor (``auto_recharacterize``) detects.  Applied at
    PUBLISH time: the first frame whose timestamp reaches ``at`` is already
    drawn from the new regime."""
    at: float
    camera_id: str
    dynamics: str = "complex"


@dataclasses.dataclass(frozen=True)
class TenantJoin:
    """A new tenant session joins the shared fleet mid-scenario under an
    SLO class, subscribing its own view of the cameras from ``at`` to
    scenario end.  The join passes through fleet-wide admission control:
    under ``admission="degrade"`` (default) lower SLO classes absorb the
    shortfall (``TENANT_DEGRADED`` events); under ``"reject"`` an
    infeasible join raises and is logged ``admitted=False``.  ``cameras``
    defaults to the whole fleet; QoS bounds default to the SLO class's
    (latency, accuracy) pair."""
    at: float
    tenant: str
    slo: str = "best_effort"
    cameras: tuple[str, ...] | None = None
    latency: float | None = None
    accuracy: float | None = None
    admission: str = "degrade"


@dataclasses.dataclass(frozen=True)
class TenantLeave:
    """The tenant's session closes; admission control re-divides the freed
    wire budget across the remaining tenants (degraded lanes restore)."""
    at: float
    tenant: str


@dataclasses.dataclass(frozen=True)
class TableStaleness:
    """Fault injection: ONE camera's LIVE tables go stale in place
    (``CamBroker.inject_table_staleness``) -- the size axis is rescaled by
    ``factor`` while the accuracy claims stay, as if the scene drifted
    since characterization.  A deterministic, scene-independent way to
    exercise the drift-detection loop: the predicted-vs-observed wire-size
    residual steps to ``|1/factor - 1|`` immediately."""
    at: float
    camera_id: str
    factor: float = 0.5


@dataclasses.dataclass(frozen=True)
class CameraMigrate:
    """Live herd migration (federated scenarios only): move one camera --
    log tail, live tables, controller lane state -- to another broker
    mid-stream.  The subscriber keeps polling transparently: no frame
    loss, no duplicate, a ``CAMERA_MIGRATED`` event on the stream."""
    at: float
    camera_id: str
    to_broker: int


@dataclasses.dataclass(frozen=True)
class BrokerOverload:
    """Fault injection (federated scenarios only): shrink one broker's
    wire budget by ``factor`` (a degraded backhaul) and run the herd's
    overload policy -- ``BROKER_OVERLOAD`` events fire and the newest
    best-effort lanes migrate off the hot broker first, mirroring
    admission control's degradation order."""
    at: float
    broker: int
    factor: float = 0.5


@dataclasses.dataclass(frozen=True)
class RollingUpgrade:
    """Rolling edge upgrade (federated scenarios only): for each broker in
    turn, migrate its cameras to the least-loaded peer, then crash +
    recover the emptied broker.  Zero frame loss, no subscriber-visible
    downtime."""
    at: float


_CONTINUOUS = (InterferenceSpike, CongestionRamp, DistanceDrift)
# applied while frames are being published, before the polling loop starts
# (the virtual clock of a SceneShift is the publish timestamp)
_PUBLISH_PHASE = (SceneShift,)


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A complete, seeded scenario: fleet + QoS + timeline.

    ``frames`` is per camera; the virtual clock runs in stream seconds
    (camera fps maps frames to timestamps).  ``fleet`` selects the fleet
    control plane (one fused controller tick on the device per poll).
    """
    name: str
    cameras: tuple[CameraSpec, ...] = (CameraSpec("cam0"),)
    frames: int = 40
    seed: int = 3
    workload: str | None = "jaad"
    latency: float = 0.100             # seconds, p95 upper bound
    accuracy: float = 0.95             # normalized F1 lower bound
    controlled: bool = True
    fleet: bool = False
    # a mesh splitting the fused fleet tick's lanes over several devices:
    # not ported, so anything but None is refused (MESH_NOT_PORTED)
    mesh: object = None
    credit_limit: int = 2
    feedback_window: int = 8
    max_frames_per_poll: int | None = None   # default: n_cameras * credit
    clip_len: int = 12                 # characterization clip length
    min_accuracy: float = 0.90         # characterization keep floor
    record_decisions: bool = False     # keep fleet decision history (parity)
    # drift-aware auto-recharacterization: arm the per-subscription
    # staleness monitor so stale tables (SceneShift / TableStaleness)
    # re-sweep automatically, no operator QosChange/TableRefresh needed
    auto_recharacterize: bool = False
    drift_config: DriftConfig | None = None
    # score every delivered frame's MEASURED detection accuracy against the
    # full-quality stream (pseudo-GT, the refresh_tables protocol): (tp,
    # fp, fn) counts per trace row, aggregated by
    # ``ScenarioResult.measured_f1``.  Costs one host detector pass per
    # published + delivered frame; off by default.
    score_frames: bool = False
    # pre-built SubscriptionOptions for the main subscription; when set it
    # is used AS-IS and the legacy per-field knobs above (controlled,
    # fleet, mesh, credit_limit, feedback_window, auto_recharacterize,
    # drift_config) are ignored
    options: SubscriptionOptions | None = None
    # aggregate bytes/s admission control divides across SLO-classed
    # tenants (None = the channel's base rate); only consulted once a
    # TenantJoin puts an SLO class on the fleet
    wire_budget: float | None = None
    # >1 builds a FederatedMezSystem: a BrokerHerd of this many EdgeBrokers
    # behind one routing table, unlocking CameraMigrate / BrokerOverload /
    # RollingUpgrade events and broker-scoped EdgeCrash.  1 (default) keeps
    # the single-broker MezSystem and a byte-identical trace.
    n_brokers: int = 1
    events: tuple = ()


# =============================================================================
# Trace rows and results
# =============================================================================


@dataclasses.dataclass(frozen=True)
class TraceRow:
    """One delivered (or knob5-dropped) frame of the scenario trace."""
    camera_id: str
    timestamp: float
    latency_s: float | None        # None for dropped frames
    wire_bytes: int
    knob_index: int
    accuracy: float | None         # table-predicted normalized F1 (1.0 = raw)
    infeasible: bool
    dropped: bool

    def as_list(self) -> list:
        return [self.camera_id, self.timestamp, self.latency_s,
                self.wire_bytes, self.knob_index, self.accuracy,
                int(self.infeasible), int(self.dropped)]


@dataclasses.dataclass
class ScenarioResult:
    """Per-frame traces + the event log of one scenario run."""
    name: str
    rows: list[TraceRow]
    events_log: list[dict]
    fleet_history: list[dict]
    camera_ids: tuple[str, ...]
    # table layouts the fleet tick ran on by scenario end (None for
    # host-path runs; ``FleetController.cache_size``): 1 proves every
    # retarget/table hot-swap kept the tick's shapes
    fleet_cache_size: int | None = None
    # per-row measured detection counts (tp, fp, fn) against the
    # full-quality pseudo-GT, aligned with ``rows`` (a knob5-dropped row
    # counts its pseudo-GT as false negatives; whole field None unless
    # spec.score_frames)
    measured_counts: list | None = None
    # drift-monitor telemetry (None unless spec.auto_recharacterize):
    # layout count (1 = the vectorized monitor kept its shapes;
    # ``DriftMonitor.cache_size``) and cumulative fires per camera
    drift_cache_size: int | None = None
    drift_fire_counts: dict | None = None
    # per-tenant delivery/accuracy aggregates (only populated when the
    # timeline contains TenantJoin events): tenant -> {slo, admitted,
    # delivered, dropped, mean_accuracy, min_budget_scale, [f1]}
    tenant_stats: dict | None = None
    # gauntlet telemetry -- kept OUT of compact() so golden traces are
    # unaffected: per-tenant delivered-latency samples (seconds), the
    # edge's credit ledger (EdgeBroker.credit_report, captured before
    # teardown), and the shared-frame-cache counters
    tenant_latencies: dict | None = None
    credit_stats: dict | None = None
    cache_stats: dict | None = None

    # -- trace queries -------------------------------------------------------
    def select(self, t0: float | None = None, t1: float | None = None, *,
               camera_id: str | None = None,
               delivered_only: bool = True) -> list[TraceRow]:
        out = []
        for r in self.rows:
            if t0 is not None and r.timestamp < t0:
                continue
            if t1 is not None and r.timestamp >= t1:
                continue
            if camera_id is not None and r.camera_id != camera_id:
                continue
            if delivered_only and r.dropped:
                continue
            out.append(r)
        return out

    def mean_accuracy(self, t0: float | None = None,
                      t1: float | None = None, *,
                      camera_id: str | None = None) -> float:
        accs = [r.accuracy for r in self.select(t0, t1, camera_id=camera_id)
                if r.accuracy is not None]
        return float(np.mean(accs)) if accs else float("nan")

    def min_accuracy(self, t0: float | None = None,
                     t1: float | None = None) -> float:
        accs = [r.accuracy for r in self.select(t0, t1)
                if r.accuracy is not None]
        return float(min(accs)) if accs else float("nan")

    def measured_f1(self, t0: float | None = None,
                    t1: float | None = None, *,
                    camera_id: str | None = None) -> float:
        """Windowed MEASURED detection F1 vs the full-quality pseudo-GT
        (counts aggregated over the window, then F1 -- the paper's
        evaluation protocol, knob5-dropped frames contributing their
        pseudo-GT as false negatives).  Because the pseudo-GT is the
        unmodified stream's own detections, this IS normalized F1: the
        full-quality arm scores exactly 1.0.  Requires
        ``spec.score_frames``."""
        if self.measured_counts is None:
            raise ValueError("scenario was run without score_frames=True")
        tp = fp = fn = 0
        for r, c in zip(self.rows, self.measured_counts):
            if c is None:
                continue
            if t0 is not None and r.timestamp < t0:
                continue
            if t1 is not None and r.timestamp >= t1:
                continue
            if camera_id is not None and r.camera_id != camera_id:
                continue
            tp += c[0]; fp += c[1]; fn += c[2]
        return det.f1_from_counts(tp, fp, fn)

    def p95_latency_ms(self, t0: float | None = None,
                       t1: float | None = None, *,
                       camera_id: str | None = None) -> float:
        lats = [r.latency_s for r in self.select(t0, t1, camera_id=camera_id)
                if r.latency_s is not None]
        return float(np.percentile(lats, 95) * 1e3) if lats else float("nan")

    def summary(self) -> dict:
        per_cam = {}
        for cid in self.camera_ids:
            rows = self.select(camera_id=cid)
            per_cam[cid] = {
                "delivered": len(rows),
                "dropped": sum(1 for r in self.rows
                               if r.camera_id == cid and r.dropped),
                "p95_ms": self.p95_latency_ms(camera_id=cid),
                "mean_accuracy": self.mean_accuracy(camera_id=cid),
                "infeasible": sum(1 for r in rows if r.infeasible),
            }
        return {
            "name": self.name,
            "frames": len(self.rows),
            "p95_ms": self.p95_latency_ms(),
            "mean_accuracy": self.mean_accuracy(),
            "min_accuracy": self.min_accuracy(),
            "events": len(self.events_log),
            "per_camera": per_cam,
        }

    # -- golden-trace serialization ------------------------------------------
    def compact(self) -> dict:
        """Stable JSON shape for golden-trace regression tests: full-precision
        floats (``repr`` round-trip), schema-versioned."""
        return {
            "schema": 1,
            "name": self.name,
            "cameras": list(self.camera_ids),
            "columns": ["camera_id", "timestamp", "latency_s", "wire_bytes",
                        "knob_index", "accuracy", "infeasible", "dropped"],
            "rows": [r.as_list() for r in self.rows],
            "events": self.events_log,
            **({"tenant_stats": self.tenant_stats}
               if self.tenant_stats else {}),
        }

    def to_json(self, *, indent: int | None = None) -> str:
        return json.dumps(self.compact(), indent=indent)


# =============================================================================
# The engine
# =============================================================================


class _Engine:
    """Applies the spec's timeline to the live system at each clock tick."""

    def __init__(self, spec: ScenarioSpec, system: MezSystem, session,
                 subscription, events_log: list[dict], *,
                 client: MezClient | None = None,
                 t_end: float = 0.0):
        self.spec = spec
        self.system = system
        self.session = session
        self.sub = subscription
        self.log = events_log
        self.client = client
        self.t_end = t_end
        # live tenant sessions keyed by tenant name: {"session", "sub",
        # "slo"}; polled in sorted-name order each tick after the main
        # subscription (deterministic interleave)
        self.tenants: dict[str, dict] = {}
        self.tenant_stats: dict[str, dict] = {}
        self.continuous = [e for e in spec.events
                           if isinstance(e, _CONTINUOUS)]
        self.oneshot = sorted(
            (e for e in spec.events
             if not isinstance(e, _CONTINUOUS + _PUBLISH_PHASE)),
            key=lambda e: e.at)
        self._fired = 0
        self._base_interference = system.channel.config.interference
        self._base_distance = {c.camera_id: c.distance_m
                               for c in spec.cameras}
        self._ghosts: list[str] = []
        # cameras that recovered while the edge broker was down: their
        # subscription reattach (which returns any fetch credits the crash
        # stranded) can only happen once the edge answers RPCs again
        self._pending_reattach: list[str] = []

    def next_oneshot_after(self, t: float) -> float | None:
        for e in self.oneshot[self._fired:]:
            if e.at > t:
                return e.at
        return None

    def tick(self, t: float) -> None:
        # one-shots due at or before t, each exactly once, in timeline order
        while self._fired < len(self.oneshot) and \
                self.oneshot[self._fired].at <= t:
            ev = self.oneshot[self._fired]
            self._fired += 1
            self._apply_oneshot(ev, t)
        # continuous dynamics re-evaluated every tick
        ch = self.system.channel
        interference = self._base_interference
        ghosts_wanted = 0
        for e in self.continuous:
            if isinstance(e, InterferenceSpike):
                interference *= e.factor_at(t)
            elif isinstance(e, CongestionRamp):
                ghosts_wanted += e.peers_at(t)
            elif isinstance(e, DistanceDrift):
                cam = self.system.cams.get(e.camera_id)
                if cam is not None:
                    cam.distance_m = e.distance_at(
                        t, self._base_distance.get(e.camera_id, 6.0))
        if interference != ch.config.interference:
            ch.set_interference(interference)
        while len(self._ghosts) < ghosts_wanted:
            gid = f"__ghost{len(self._ghosts)}"
            self._ghosts.append(gid)
            ch.activate(gid)
        while len(self._ghosts) > ghosts_wanted:
            ch.deactivate(self._ghosts.pop())

    def _herd(self, event_name: str):
        """The BrokerHerd behind a federated system, or a clear error when
        the scenario forgot ``n_brokers > 1``."""
        herd = getattr(self.system, "herd", None)
        if herd is None:
            raise TypeError(
                f"{event_name} requires a federated scenario: set "
                f"n_brokers > 1 on the ScenarioSpec")
        return herd

    def _reattach(self, camera_id: str):
        """Re-admit one recovered camera into the main subscription and
        every tenant subscription sharing it (their held fetch credits
        return; a tenant left failed would leak its lane for the rest of
        the run)."""
        status = self.system.edge.reattach_camera(
            self.sub.subscription_id, camera_id)
        for st in self.tenants.values():
            self.system.edge.reattach_camera(
                st["sub"].subscription_id, camera_id)
        return status

    def _apply_oneshot(self, ev, t: float) -> None:
        entry = {"t": t, "at": ev.at, "kind": type(ev).__name__}
        if isinstance(ev, PeerJoin):
            self.system.channel.activate(ev.node_id)
        elif isinstance(ev, PeerLeave):
            self.system.channel.deactivate(ev.node_id)
        elif isinstance(ev, CameraCrash):
            self.system.cams[ev.camera_id].crash()
            entry["camera_id"] = ev.camera_id
        elif isinstance(ev, CameraRecover):
            self.system.cams[ev.camera_id].recover()
            entry["camera_id"] = ev.camera_id
            if self.system.edge.crashed:
                # the node is back but no broker can re-admit it yet:
                # defer to EdgeRecover
                self._pending_reattach.append(ev.camera_id)
                entry["reattach"] = "deferred"
            else:
                entry["reattach"] = self._reattach(ev.camera_id).value
        elif isinstance(ev, EdgeCrash):
            if ev.broker is None:
                self.system.edge.crash()
            else:
                self._herd("EdgeCrash").crash(broker=ev.broker)
                entry["broker"] = ev.broker
        elif isinstance(ev, EdgeRecover):
            if ev.broker is None:
                self.system.edge.recover()
            else:
                self._herd("EdgeRecover").recover(broker=ev.broker)
                entry["broker"] = ev.broker
            if self._pending_reattach and not self.system.edge.crashed:
                for cid in self._pending_reattach:
                    self._reattach(cid)
                entry["reattached"] = self._pending_reattach
                self._pending_reattach = []
        elif isinstance(ev, CameraMigrate):
            herd = self._herd("CameraMigrate")
            entry["camera_id"] = ev.camera_id
            entry["to_broker"] = ev.to_broker
            entry["moved"] = herd.migrate_camera(ev.camera_id, ev.to_broker,
                                                 at=ev.at)
        elif isinstance(ev, BrokerOverload):
            herd = self._herd("BrokerOverload")
            budget = herd.brokers[ev.broker]._wire_budget
            if budget is None:
                budget = self.system.channel.config.base_rate
            herd.set_wire_budget(ev.broker, budget * ev.factor)
            moves = herd.rebalance(at=ev.at)
            entry["broker"] = ev.broker
            entry["factor"] = ev.factor
            entry["moves"] = [(cid, src, dst) for cid, src, dst in moves]
        elif isinstance(ev, RollingUpgrade):
            herd = self._herd("RollingUpgrade")
            entry["upgraded"] = herd.rolling_upgrade(at=ev.at)
        elif isinstance(ev, QosChange):
            q = self.sub.update_qos(latency=ev.latency, accuracy=ev.accuracy,
                                    recharacterize=ev.recharacterize)
            entry["status"] = q.status.value
            entry["recharacterized"] = list(q.recharacterized)
        elif isinstance(ev, TableRefresh):
            cam = self.system.cams[ev.camera_id]
            entry["camera_id"] = ev.camera_id
            entry["refreshed"] = cam.recharacterize()
        elif isinstance(ev, TableStaleness):
            cam = self.system.cams[ev.camera_id]
            entry["camera_id"] = ev.camera_id
            entry["factor"] = ev.factor
            entry["stale"] = cam.inject_table_staleness(ev.factor)
        elif isinstance(ev, TenantJoin):
            slo = resolve_slo(ev.slo)
            entry["tenant"] = ev.tenant
            entry["slo"] = slo.name
            cam_ids = (list(ev.cameras) if ev.cameras is not None
                       else [c.camera_id for c in self.spec.cameras])
            lat = ev.latency if ev.latency is not None else slo.max_latency
            acc = (ev.accuracy if ev.accuracy is not None
                   else slo.min_accuracy)
            sess = self.client.open_session(f"tenant-{ev.tenant}",
                                            tenant=ev.tenant, slo=slo)
            stats = self.tenant_stats.setdefault(ev.tenant, {
                "slo": slo.name, "admitted": False, "delivered": 0,
                "dropped": 0, "acc_sum": 0.0, "acc_n": 0,
                "min_budget_scale": 1.0})
            try:
                sub = sess.subscribe(
                    cam_ids, ev.at, self.t_end, qos=QosBounds(lat, acc),
                    options=SubscriptionOptions(tenant=ev.tenant, slo=slo,
                                                admission=ev.admission))
            except AdmissionRejected as e:
                entry["admitted"] = False
                entry["detail"] = str(e)
                for sev in sess.events():
                    self.log.append({"t": t, "kind": sev.kind.value,
                                     "tenant": ev.tenant,
                                     "detail": sev.detail})
                sess.close()
            else:
                entry["admitted"] = True
                stats["admitted"] = True
                self.tenants[ev.tenant] = {"session": sess, "sub": sub,
                                           "slo": slo}
        elif isinstance(ev, TenantLeave):
            st = self.tenants.pop(ev.tenant, None)
            entry["tenant"] = ev.tenant
            entry["closed"] = st is not None
            if st is not None:
                for sev in st["sub"].events():
                    self.log.append({"t": t, "kind": sev.kind.value,
                                     "tenant": ev.tenant,
                                     "detail": sev.detail})
                st["session"].close()
        else:
            raise TypeError(f"unknown scenario event {type(ev).__name__}")
        self.log.append(entry)


def _poll_tenants(engine: _Engine, system: MezSystem, max_frames: int,
                  frame_acc, frame_counts, clock: float) -> int:
    """One poll round over every live tenant subscription (sorted tenant
    order -- deterministic interleave with the main stream), folding frames
    into per-tenant aggregates and tenant events into the scenario log.
    Returns the number of frames seen."""
    if not engine.tenants:
        return 0
    seen = 0
    for name in sorted(engine.tenants):
        st = engine.tenants[name]
        stats = engine.tenant_stats[name]
        try:
            batch = st["sub"].poll(max_frames=max_frames)
        except RPCTimeout:
            continue
        seen += len(batch)
        for d in batch.frames:
            cam = system.cams.get(d.camera_id)
            if d.frame is None:
                stats["dropped"] += 1
            else:
                stats["delivered"] += 1
                # per-tenant delivered-latency samples (seconds): the
                # gauntlet's tail-percentile pool; excluded from
                # compact()/goldens
                stats.setdefault("lat", []).append(float(d.latency.total))
            acc = frame_acc(d, cam)
            if acc is not None:
                stats["acc_sum"] += acc
                stats["acc_n"] += 1
            c = frame_counts(d, cam)
            if c is not None:
                agg = stats.setdefault("counts", [0, 0, 0])
                agg[0] += c[0]; agg[1] += c[1]; agg[2] += c[2]
        for ev in st["sub"].events():
            engine.log.append({"t": clock, "kind": ev.kind.value,
                               "tenant": name, "detail": ev.detail})
    # track how deep admission control pushed each tenant's wire allocation
    report = system.edge.wire_report()
    for name, st in engine.tenants.items():
        sid = st["sub"].subscription_id
        scale = report["subscriptions"].get(sid, {}).get("scale", 1.0)
        stats = engine.tenant_stats[name]
        stats["min_budget_scale"] = min(stats["min_budget_scale"], scale)
    return seen


def run_scenario(
    spec: ScenarioSpec, *,
    table_provider: Callable[[str], CharacterizationTable] | None = None,
    tables: Mapping[str, CharacterizationTable] | None = None,
    device: "str | torch.device | None" = None,
) -> ScenarioResult:
    """Build the fleet, run the scripted closed loop, return the trace.

    ``table_provider`` maps a dynamics name to a ``CharacterizationTable``
    (tests inject synthetic or cached tables; default runs the batched
    ``characterize`` sweep once per distinct dynamics).  ``tables`` is a
    pre-resolved mapping taking precedence over the provider; its keys may
    be dynamics names OR camera ids -- a camera-id key wins, so
    heterogeneous fleets can run per-camera calibrated tables (the fig12
    benchmark does: a table characterized on one camera's background is
    already mildly stale for another's, which would trip the drift
    monitor before the scripted shift).

    ``device`` (default ``"cuda"``) runs the characterization sweep, the
    brokers' fleet ticks and live re-sweeps; without a CUDA device it
    raises unless ``device="cpu"`` is asked for.
    """
    if spec.mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    dev = resolve_device(device)
    resolved: dict[str, CharacterizationTable] = dict(tables or {})

    def table_for(camera_id: str, dynamics: str,
                  seed: int) -> CharacterizationTable:
        if camera_id in resolved:
            return resolved[camera_id]
        if dynamics not in resolved:
            if table_provider is not None:
                resolved[dynamics] = table_provider(dynamics)
            else:
                resolved[dynamics] = characterize(
                    lambda: SyntheticCamera(CameraConfig(
                        dynamics=dynamics, seed=seed)),
                    clip_len=spec.clip_len,
                    min_accuracy=spec.min_accuracy, device=dev)
        return resolved[dynamics]

    ch = calibrated_channel(seed=spec.seed, workload=spec.workload)
    if spec.n_brokers > 1:
        system = FederatedMezSystem(ch, n_brokers=spec.n_brokers,
                                    wire_budget=spec.wire_budget, device=dev)
    else:
        system = MezSystem(ch, wire_budget=spec.wire_budget, device=dev)
    n_cams = len(spec.cameras)
    fps = max(c.fps for c in spec.cameras)
    events_log: list[dict] = []
    # full-quality pseudo-GT detections per published frame, keyed by
    # (camera_id, timestamp) -- only populated under spec.score_frames
    base_dets: dict[tuple[str, float], np.ndarray] = {}
    for cs in spec.cameras:
        cam = system.add_camera(cs.camera_id, distance_m=cs.distance_m,
                                fps=cs.fps)
        src = SyntheticCamera(CameraConfig(
            camera_id=cs.camera_id, dynamics=cs.dynamics, seed=cs.seed,
            fps=cs.fps))
        cam.background = src.background
        tbl = table_for(cs.camera_id, cs.dynamics, cs.seed)
        sizes = np.linspace(tbl.sizes_sorted[0], tbl.sizes_sorted[-1], 16)
        reg = fit_latency_regression(
            sizes, ch.regression_points(sizes, n=n_cams))
        cam.set_target(spec.latency, spec.accuracy, tbl, reg)
        shifts = sorted((e for e in spec.events
                         if isinstance(e, SceneShift)
                         and e.camera_id == cs.camera_id),
                        key=lambda e: e.at)
        si = 0
        for fi in range(spec.frames):
            # the shift lands on the first frame whose timestamp reaches it
            while si < len(shifts) and fi / cs.fps >= shifts[si].at:
                src.set_dynamics(shifts[si].dynamics)
                events_log.append({"t": fi / cs.fps, "at": shifts[si].at,
                                   "kind": "SceneShift",
                                   "camera_id": cs.camera_id,
                                   "dynamics": shifts[si].dynamics})
                si += 1
            ts, frame, _ = src.next_frame()
            cam.publish(ts, frame)
            if spec.score_frames:
                base_dets[(cs.camera_id, float(ts))] = det.detect(
                    frame, src.background)

    client = MezClient(system)
    rows: list[TraceRow] = []
    measured: list[tuple[int, int, int] | None] = []
    max_frames = spec.max_frames_per_poll or n_cams * spec.credit_limit
    opts = spec.options if spec.options is not None else SubscriptionOptions(
        controlled=spec.controlled, feedback_window=spec.feedback_window,
        credit_limit=spec.credit_limit, fleet=spec.fleet,
        auto_recharacterize=spec.auto_recharacterize,
        drift_config=spec.drift_config)

    def frame_acc(d, cam):
        """Table-predicted normalized F1 of one delivered frame."""
        if d.frame is None:
            return None
        if d.knob_index >= 0 and cam is not None \
                and cam.controller is not None:
            return float(cam.controller.table.acc_by_setting[d.knob_index])
        return 1.0                         # raw frame = full fidelity

    def frame_counts(d, cam):
        """Measured (tp, fp, fn) vs the full-quality pseudo-GT (None when
        unscored)."""
        if not spec.score_frames or cam is None:
            return None
        base = base_dets.get((d.camera_id, float(d.timestamp)))
        if base is None:
            return None
        if d.frame is None:
            # knob5-dropped: the application never saw the frame, its
            # pseudo-GT becomes false negatives (detector.normalized_f1's
            # protocol)
            return (0, 0, len(base))
        if d.knob_index >= 0 and cam.controller is not None:
            setting = cam.controller.table.setting_for(d.knob_index)
            bg = cam.degraded_background(setting)
        else:
            bg = cam.background
        boxes = det.detect(np.asarray(d.frame), bg,
                           scale_to=cam.background.shape[:2])
        return det.match_f1(base, boxes)

    sess = client.open_session(f"scenario-{spec.name}")
    try:
        sub = sess.subscribe([c.camera_id for c in spec.cameras],
                             0.0, spec.frames / fps,
                             qos=QosBounds(spec.latency, spec.accuracy),
                             options=opts)
        fleet = system.edge.subscription_fleet(sub.subscription_id)
        if fleet is not None and spec.record_decisions:
            fleet.record_history = True
        engine = _Engine(spec, system, sess, sub, events_log,
                         client=client, t_end=spec.frames / fps)
        clock = 0.0
        while True:
            engine.tick(clock)
            try:
                batch = sub.poll(max_frames=max_frames)
            except RPCTimeout as e:
                # edge down / all cameras unreachable: skip virtual time
                # forward to the next scripted event (recovery) -- or end
                # the scenario when nothing is scheduled to change
                events_log.append({"t": clock, "kind": "RPCTimeout",
                                   "detail": str(e)})
                nxt = engine.next_oneshot_after(clock)
                if nxt is None:
                    break
                clock = nxt
                continue
            _poll_tenants(engine, system, max_frames, frame_acc,
                          frame_counts, clock)
            if not batch:
                break
            for d in batch.frames:
                cam = system.cams.get(d.camera_id)
                acc = frame_acc(d, cam)
                counts = frame_counts(d, cam)
                measured.append(counts)
                rows.append(TraceRow(
                    camera_id=d.camera_id,
                    timestamp=float(d.timestamp),
                    latency_s=(float(d.latency.total)
                               if d.frame is not None else None),
                    wire_bytes=int(d.wire_bytes),
                    knob_index=int(d.knob_index),
                    accuracy=acc,
                    infeasible=bool(d.infeasible),
                    dropped=d.frame is None,
                ))
                clock = max(clock, float(d.timestamp))
            for ev in sub.events():
                events_log.append({"t": clock, "kind": ev.kind.value,
                                   "camera_id": ev.camera_id,
                                   "detail": ev.detail})
        # tenants may still hold undelivered frames after the main
        # subscription drains: keep polling until every stream is dry
        while engine.tenants:
            if not _poll_tenants(engine, system, max_frames, frame_acc,
                                 frame_counts, clock):
                break
        tenant_stats = None
        tenant_latencies = None
        if engine.tenant_stats:
            tenant_stats = {}
            tenant_latencies = {}
            for name, s in sorted(engine.tenant_stats.items()):
                out = {"slo": s["slo"], "admitted": s["admitted"],
                       "delivered": s["delivered"], "dropped": s["dropped"],
                       "mean_accuracy": (s["acc_sum"] / s["acc_n"]
                                         if s["acc_n"] else None),
                       "min_budget_scale": s["min_budget_scale"]}
                if "counts" in s:
                    out["f1"] = det.f1_from_counts(*s["counts"])
                tenant_stats[name] = out
                tenant_latencies[name] = s.get("lat", [])
        # gauntlet telemetry, captured BEFORE teardown: session close
        # writes still-held credits off as dropped, which would mask the
        # in_flight signal the crash-wave gate watches
        credit_stats = system.edge.credit_report()
        fc = system.edge.frame_cache
        cache_stats = {"hits": fc.hits, "misses": fc.misses,
                       "evictions": fc.evictions, "hit_rate": fc.hit_rate(),
                       "size": len(fc), "capacity": fc.capacity}
        for st in engine.tenants.values():
            try:
                st["session"].close()
            except RPCTimeout:
                pass
        engine.tenants.clear()
        fleet = system.edge.subscription_fleet(sub.subscription_id)
        history = list(fleet.history) if fleet is not None else []
        cache_size = fleet.cache_size() if fleet is not None else None
        drift = system.edge.subscription_drift(sub.subscription_id)
        drift_cache = drift.cache_size() if drift is not None else None
        drift_fires = drift.fire_counts() if drift is not None else None
    finally:
        try:
            sess.close()
        except RPCTimeout:
            pass              # edge left crashed at scenario end
    return ScenarioResult(
        name=spec.name, rows=rows, events_log=events_log,
        fleet_history=history,
        camera_ids=tuple(c.camera_id for c in spec.cameras),
        fleet_cache_size=cache_size,
        measured_counts=measured if spec.score_frames else None,
        drift_cache_size=drift_cache,
        drift_fire_counts=drift_fires,
        tenant_stats=tenant_stats,
        tenant_latencies=tenant_latencies,
        credit_stats=credit_stats,
        cache_stats=cache_stats)
