"""Federated broker tier: a herd of ``EdgeBroker``s behind one routing table.

A single edge broker is Mez's scalability and availability bottleneck: an
edge crash stalls every camera behind it and a hot broker has no way to
shed load.  ``BrokerHerd`` federates N independent ``EdgeBroker``s --
FogMQ's broker-herd/migration design -- while presenting the exact
``SessionedMessagingSystem`` surface one broker does, so ``MezClient`` /
``Session`` / ``run_scenario`` work against a herd unchanged.

Topology
    Every camera routes to exactly one broker (``_cam_route``).  A herd
    session lazily opens one local session per broker it touches; a herd
    subscription decomposes into per-broker *parts* (one local
    subscription per broker holding any of its cameras).  Polls fan out to
    the parts with a per-camera frame budget identical to the
    single-broker share split, and the part batches are merged back in
    ``(timestamp, camera_id)`` order -- a no-migration federated trace is
    frame-identical to the same workload on one broker.

Live migration (``migrate_camera``)
    The ``CamBroker`` object itself moves: its host log, live
    characterization table + device tables, and host PI controller travel
    with it.  Every broker of a herd, and every camera, lives on one
    ``torch.device``, so the device tables move as they are: nothing is
    copied through the host.  The source broker drains the camera's
    in-flight fetch credits (returned to the ledger exactly like a crash
    reattach, so ``credit_report()`` stays conserved herd-wide), exports
    each fleet lane's PI state back into the host controller
    (``FleetController.export_lane`` -- no layout change on either side),
    and hands over the edge replica tail.  The target replays the tail
    into a fresh replica (the log's monotonic-timestamp ordering rule
    dedupes the at-most-one overlapping frame), re-creates each affected
    subscription part with ``retarget=False`` (the controller keeps its
    target and carried integral), and imports the cursors so polling
    resumes exactly where it stopped -- no frame loss, no duplicate
    delivery, and the subscriber never sees anything but a
    ``CAMERA_MIGRATED`` event.

Overload policy (``rebalance``)
    Per-broker watermarks -- offered wire load over ``overload_ratio`` x
    budget, or delivered-latency p95 over ``latency_watermark`` -- mark a
    broker overloaded.  The herd emits ``BROKER_OVERLOAD`` on every
    affected subscription and migrates cameras of the NEWEST
    lowest-priority SLO lanes first (ascending ``(priority, -seq)`` --
    best_effort before silver before gold, newest first within a class,
    mirroring admission control's degradation order) to the least-loaded
    broker until the watermark clears.  Untenanted subscriptions are never
    shed, mirroring admission's protected demand.

Rolling upgrade (``rolling_upgrade``)
    For each broker in turn: migrate its cameras to the least-loaded peer,
    crash + recover the (now empty) broker, and proceed -- a full-herd
    restart with zero frame loss and no subscriber-visible downtime.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.api import (AdmissionRejected, BoundedEventBuffer,
                                  EventKind, FrameBatch, QosUpdate,
                                  RPCTimeout, SessionEvent, SloClass, Status,
                                  SubscribeSpec, SubscriptionOptions,
                                  SubscriptionState)
from repro_torch.core.broker import CamBroker, EdgeBroker
from repro_torch.core.channel import WirelessChannel
from repro_torch.core.log import LogSegmentStore
from repro_torch.device import resolve_device

__all__ = ["BrokerHerd", "FederatedMezSystem"]


@dataclasses.dataclass
class _Part:
    """One broker-local slice of a herd subscription."""
    broker: int
    sub_id: str                    # local (broker-side) subscription id
    cameras: list[str]


@dataclasses.dataclass
class _HerdSub:
    sub_id: str                    # herd-level id ("hsub-N")
    session_id: str                # herd-level session id
    specs: dict[str, SubscribeSpec]
    options: SubscriptionOptions | None
    parts: list[_Part]
    seq: int
    # herd-level events (CAMERA_MIGRATED, BROKER_OVERLOAD); the parts'
    # broker-side buffers are drained and re-stamped alongside
    events: BoundedEventBuffer = dataclasses.field(
        default_factory=BoundedEventBuffer)

    def part_of(self, camera_id: str) -> _Part | None:
        for p in self.parts:
            if camera_id in p.cameras:
                return p
        return None


@dataclasses.dataclass
class _HerdSession:
    session_id: str                # herd-level id ("hsess-N")
    application_id: str
    tenant: str | None
    slo: SloClass | str | None
    locals: dict[int, str] = dataclasses.field(default_factory=dict)
    sub_ids: list[str] = dataclasses.field(default_factory=list)


class _HerdCacheView:
    """Read-only aggregate over the brokers' shared frame caches, shaped
    like one ``SharedFrameCache`` for introspection (hits/misses/evictions,
    ``hit_rate()``, ``len``)."""

    def __init__(self, brokers: list[EdgeBroker]):
        self._brokers = brokers

    def _caches(self):
        return [b.frame_cache for b in self._brokers]

    @property
    def hits(self) -> int:
        return sum(c.hits for c in self._caches())

    @property
    def misses(self) -> int:
        return sum(c.misses for c in self._caches())

    @property
    def evictions(self) -> int:
        return sum(c.evictions for c in self._caches())

    @property
    def capacity(self) -> int:
        return sum(c.capacity for c in self._caches())

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        return sum(len(c) for c in self._caches())


class BrokerHerd:
    """N ``EdgeBroker``s behind one routing table, speaking the single-broker
    session surface (see module docstring).

    ``wire_budget`` is PER BROKER (None -> each broker falls back to the
    shared channel's base rate): a herd of two brokers at budget B serves
    each camera under exactly the admission pressure a lone broker at B
    would, which keeps federated and single-broker traces comparable.

    Every broker runs its fleet ticks and re-sweeps on ``device``
    (default ``"cuda"``).
    """

    def __init__(self, n_brokers: int = 2, *, log_capacity: int = 4096,
                 store: LogSegmentStore | None = None,
                 wire_budget: float | None = None,
                 overload_ratio: float = 0.95,
                 latency_watermark: float | None = None,
                 device: "str | torch.device | None" = None):
        if n_brokers < 1:
            raise ValueError(f"need at least one broker, got {n_brokers}")
        self.device = resolve_device(device)
        self.brokers = [
            EdgeBroker(  # mezlint: disable=MZ08 -- the herd owns its brokers: the counterpart of the blessed site in repro.core.federation
                log_capacity=log_capacity, store=store,
                wire_budget=wire_budget, device=self.device)
            for _ in range(n_brokers)]
        self.store = store
        self.overload_ratio = float(overload_ratio)
        self.latency_watermark = latency_watermark
        self._cam_route: dict[str, int] = {}
        self._ids = itertools.count()
        self._sessions: dict[str, _HerdSession] = {}
        self._subs: dict[str, _HerdSub] = {}
        # (broker_idx, local_sub_id) -> herd sub id, for event re-stamping
        self._part_owner: dict[tuple[int, str], str] = {}
        # recent delivered-latency samples per broker (poll watermark)
        self._lat_window: list[list[float]] = [[] for _ in range(n_brokers)]
        self.migrations = 0
        self.frame_cache = _HerdCacheView(self.brokers)

    # -- camera routing ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.brokers)

    def register(self, cam: CamBroker, *, broker: int | None = None) -> int:
        """Route a camera to ``broker`` (default: the broker with the
        fewest cameras; stable tie-break on index) and register it there.
        The camera must live on the herd's device: migration moves its
        device tables between brokers as they are."""
        if cam.device != self.device:
            raise ValueError(f"camera {cam.camera_id!r} on {cam.device}, "
                             f"herd on {self.device}")
        if broker is None:
            counts = [0] * len(self.brokers)
            for b in self._cam_route.values():
                counts[b] += 1
            broker = int(np.argmin(counts))
        self._check_broker(broker)
        self.brokers[broker].register(cam)
        self._cam_route[cam.camera_id] = broker
        return broker

    def route_of(self, camera_id: str) -> int:
        if camera_id not in self._cam_route:
            raise RPCTimeout(f"unknown camera {camera_id}")
        return self._cam_route[camera_id]

    def _check_broker(self, idx: int) -> None:
        if not 0 <= idx < len(self.brokers):
            raise ValueError(f"broker index {idx} out of range "
                             f"[0, {len(self.brokers)})")

    def _broker_of(self, camera_id: str) -> EdgeBroker:
        return self.brokers[self.route_of(camera_id)]

    # -- SessionedMessagingSystem surface --------------------------------------------
    @property
    def crashed(self) -> bool:
        """True while ANY broker is down: scenario reattach deferral is
        conservative -- partial availability still serves polls, but
        recovery actions wait until the whole herd is back."""
        return any(b.crashed for b in self.brokers)

    def crash(self, broker: int | None = None) -> None:
        if broker is None:
            for b in self.brokers:
                b.crash()
        else:
            self._check_broker(broker)
            self.brokers[broker].crash()

    def recover(self, broker: int | None = None) -> None:
        if broker is None:
            for b in self.brokers:
                b.recover()
        else:
            self._check_broker(broker)
            self.brokers[broker].recover()

    def persist(self) -> None:
        for b in self.brokers:
            b.persist()

    def connect(self, url: str) -> str:
        return f"herd-client-{next(self._ids)}"

    def get_camera_info(self) -> list[str]:
        return sorted(self._cam_route)

    def open_session(self, application_id: str, *,
                     tenant: str | None = None,
                     slo: SloClass | str | None = None) -> str:
        sid = f"hsess-{next(self._ids)}"
        self._sessions[sid] = _HerdSession(sid, application_id, tenant, slo)
        return sid

    def _local_session(self, sess: _HerdSession, broker: int) -> str:
        if broker not in sess.locals:
            sess.locals[broker] = self.brokers[broker].open_session(
                sess.application_id, tenant=sess.tenant, slo=sess.slo)
        return sess.locals[broker]

    def close_session(self, session_id: str) -> Status:
        sess = self._sessions.pop(session_id, None)
        if sess is None:
            return Status.FAIL
        for sub_id in list(sess.sub_ids):
            self.close_subscription(sub_id)
        for broker, lsid in sess.locals.items():
            self.brokers[broker].close_session(lsid)
        return Status.OK

    def create_subscription(self, session_id: str,
                            specs: Sequence[SubscribeSpec], *,
                            options: SubscriptionOptions | None = None,
                            retarget: bool = True) -> str:
        """One herd subscription = one local part per broker that routes
        any of its cameras.  Admission runs per broker against that
        broker's wire budget; a rejection on ANY part rolls back the parts
        already created and re-raises."""
        sess = self._sessions.get(session_id)
        if sess is None:
            raise RPCTimeout(f"unknown session {session_id}")
        if not specs:
            raise ValueError("subscription needs at least one camera spec")
        by_broker: dict[int, list[SubscribeSpec]] = {}
        for spec in specs:
            by_broker.setdefault(self.route_of(spec.camera_id),
                                 []).append(spec)
        num = next(self._ids)
        hsub_id = f"hsub-{num}"
        parts: list[_Part] = []
        try:
            for broker in sorted(by_broker):
                lsid = self._local_session(sess, broker)
                local = self.brokers[broker].create_subscription(
                    lsid, by_broker[broker], options=options,
                    retarget=retarget)
                parts.append(_Part(broker, local,
                                   [s.camera_id for s in by_broker[broker]]))
        except (AdmissionRejected, RPCTimeout):
            for p in parts:
                self.brokers[p.broker].close_subscription(p.sub_id)
            raise
        rec = _HerdSub(hsub_id, session_id,
                       {s.camera_id: s for s in specs}, options, parts,
                       seq=num)
        rec.events.owner = hsub_id
        self._subs[hsub_id] = rec
        sess.sub_ids.append(hsub_id)
        for p in parts:
            self._part_owner[(p.broker, p.sub_id)] = hsub_id
        return hsub_id

    def poll_subscription(self, subscription_id: str, *,
                          max_frames: int = 16,
                          deadline: float | None = None) -> FrameBatch:
        """Fan the poll out over the parts and merge.

        Each part gets ``share x |part cameras|`` frames where ``share =
        max(1, max_frames // total cameras)`` -- the same per-camera budget
        the single-broker poll computes, so a no-migration federated run
        delivers frame-identical batches.  A part whose broker is down (or
        whose cameras all failed) raises locally; the herd re-raises only
        when EVERY part is unreachable -- otherwise the surviving brokers'
        frames are delivered and the dead part's events surface on the
        stream.  Delivered frames are never trimmed (they are fetched,
        at-most-once) -- with ``max_frames < total cameras`` the merged
        batch may slightly exceed ``max_frames``, exactly as a lone broker
        may overshoot its integer share split."""
        rec = self._subs.get(subscription_id)
        if rec is None:
            return FrameBatch((), subscription_id)
        total_cams = sum(len(p.cameras) for p in rec.parts)
        if total_cams == 0:
            return FrameBatch((), subscription_id)
        share = max(1, max_frames // total_cams)
        out = []
        errors = 0
        for part in rec.parts:
            if not part.cameras:
                continue
            try:
                batch = self.brokers[part.broker].poll_subscription(
                    part.sub_id, max_frames=share * len(part.cameras),
                    deadline=deadline)
            except RPCTimeout:
                errors += 1
                continue
            out.extend(batch.frames)
            window = self._lat_window[part.broker]
            window.extend(f.latency.total for f in batch.frames
                          if f.latency is not None)
            del window[:-256]
        if errors and errors == sum(1 for p in rec.parts if p.cameras):
            raise RPCTimeout(
                f"all parts of {subscription_id} unreachable")
        out.sort(key=lambda d: (d.timestamp, d.camera_id))
        return FrameBatch(tuple(out), subscription_id)

    def update_subscription_qos(self, subscription_id: str, *,
                                latency: float | None = None,
                                accuracy: float | None = None,
                                recharacterize: bool = False) -> QosUpdate:
        rec = self._require(subscription_id)
        updates = [self.brokers[p.broker].update_subscription_qos(
                       p.sub_id, latency=latency, accuracy=accuracy,
                       recharacterize=recharacterize)
                   for p in rec.parts]
        first = updates[0]
        return dataclasses.replace(
            first,
            subscription_id=subscription_id,
            status=(Status.OK if all(u.status is Status.OK for u in updates)
                    else Status.FAIL),
            applied_cameras=tuple(c for u in updates
                                  for c in u.applied_cameras),
            recharacterized=tuple(c for u in updates
                                  for c in u.recharacterized),
            per_camera=tuple(r for u in updates for r in u.per_camera))

    def close_subscription(self, subscription_id: str) -> Status:
        rec = self._subs.pop(subscription_id, None)
        if rec is None:
            return Status.FAIL
        status = Status.OK
        for p in rec.parts:
            self._part_owner.pop((p.broker, p.sub_id), None)
            if self.brokers[p.broker].close_subscription(p.sub_id) \
                    is not Status.OK:
                status = Status.FAIL
        sess = self._sessions.get(rec.session_id)
        if sess is not None and subscription_id in sess.sub_ids:
            sess.sub_ids.remove(subscription_id)
        return status

    def reattach_camera(self, subscription_id: str,
                        camera_id: str) -> Status:
        rec = self._subs.get(subscription_id)
        if rec is None:
            return Status.FAIL
        part = rec.part_of(camera_id)
        if part is None:
            return Status.FAIL
        return self.brokers[part.broker].reattach_camera(part.sub_id,
                                                         camera_id)

    def _require(self, subscription_id: str) -> _HerdSub:
        rec = self._subs.get(subscription_id)
        if rec is None:
            raise RPCTimeout(f"unknown subscription {subscription_id}")
        return rec

    def _restamp(self, events: list[SessionEvent],
                 hsub_id: str) -> list[SessionEvent]:
        return [dataclasses.replace(e, subscription_id=hsub_id)
                if e.subscription_id else e for e in events]

    def subscription_events(self, subscription_id: str) -> list[SessionEvent]:
        rec = self._subs.get(subscription_id)
        if rec is None:
            return []
        out = rec.events.drain()
        for p in rec.parts:
            out.extend(self._restamp(
                self.brokers[p.broker].subscription_events(p.sub_id),
                subscription_id))
        return out

    def session_events(self, session_id: str) -> list[SessionEvent]:
        sess = self._sessions.get(session_id)
        if sess is None:
            return []
        out: list[SessionEvent] = []
        for sub_id in sess.sub_ids:
            rec = self._subs.get(sub_id)
            if rec is not None:
                out.extend(rec.events.drain())
        # local drains cover session-level events (admission rejections)
        # AND the parts' per-subscription buffers; re-stamp local sub ids
        # back to herd ids where a part mapping is known
        for broker, lsid in sess.locals.items():
            for e in self.brokers[broker].session_events(lsid):
                hid = self._part_owner.get((broker, e.subscription_id))
                out.append(dataclasses.replace(e, subscription_id=hid)
                           if hid else e)
        return out

    def session_subscription_ids(self, session_id: str) -> list[str]:
        sess = self._sessions.get(session_id)
        if sess is None:
            return []
        return [sid for sid in sess.sub_ids if sid in self._subs]

    def subscription_state(self, subscription_id: str) -> SubscriptionState:
        rec = self._subs.get(subscription_id)
        if rec is None:
            return SubscriptionState.CLOSED
        states = [self.brokers[p.broker].subscription_state(p.sub_id)
                  for p in rec.parts]
        if SubscriptionState.ACTIVE in states:
            return SubscriptionState.ACTIVE
        if SubscriptionState.FAILED in states:
            return SubscriptionState.FAILED
        if SubscriptionState.DRAINED in states:
            return SubscriptionState.DRAINED
        return SubscriptionState.CLOSED

    def subscription_fleet(self, subscription_id: str):
        """The fleet control plane of the FIRST part (introspection; a
        migrated herd subscription has one fleet per part)."""
        rec = self._subs.get(subscription_id)
        if rec is None or not rec.parts:
            return None
        return self.brokers[rec.parts[0].broker].subscription_fleet(
            rec.parts[0].sub_id)

    def subscription_drift(self, subscription_id: str):
        rec = self._subs.get(subscription_id)
        if rec is None or not rec.parts:
            return None
        return self.brokers[rec.parts[0].broker].subscription_drift(
            rec.parts[0].sub_id)

    # -- herd-wide introspection -----------------------------------------------------
    def credit_report(self) -> dict:
        """The fetch-credit ledger summed over the herd.  ``leaked`` is
        recomputed from the herd totals and must be 0 through any sequence
        of crashes, migrations, and teardowns -- migration drains in-flight
        credits on the source before the route flips, so no credit is ever
        stranded on a broker that no longer routes the camera."""
        totals = {"granted": 0, "returned": 0, "in_flight": 0, "dropped": 0}
        for b in self.brokers:
            rep = b.credit_report()
            for k in totals:
                totals[k] += rep[k]
        totals["leaked"] = (totals["granted"] - totals["returned"]
                            - totals["in_flight"] - totals["dropped"])
        return totals

    def wire_report(self) -> dict:
        """Per-broker allocation reports plus one herd-level view keyed by
        HERD subscription id (a spanning subscription reports the MINIMUM
        scale across its parts -- the degradation a subscriber actually
        observes)."""
        reports = [b.wire_report() for b in self.brokers]
        subs: dict[str, dict] = {}
        for rec in self._subs.values():
            entries = []
            for p in rec.parts:
                e = reports[p.broker]["subscriptions"].get(p.sub_id)
                if e is not None:
                    entries.append(e)
            if not entries:
                continue
            subs[rec.sub_id] = {
                "tenant": entries[0]["tenant"],
                "slo": entries[0]["slo"],
                "priority": entries[0]["priority"],
                "demand_bps": sum(e["demand_bps"] for e in entries),
                "floor_bps": sum(e["floor_bps"] for e in entries),
                "scale": min(e["scale"] for e in entries),
                "allocated_bps": sum(e["allocated_bps"] for e in entries),
            }
        return {
            "budget_bps": sum(r["budget_bps"] for r in reports),
            "offered_bps": sum(r["offered_bps"] for r in reports),
            "subscriptions": subs,
            "brokers": reports,
        }

    # -- live camera migration ---------------------------------------------------------
    def migrate_camera(self, camera_id: str, to_broker: int, *,
                       at: float = 0.0) -> bool:
        """Move a camera -- and every subscription lane riding it -- to
        another broker, live.  See the module docstring for the contract.
        Returns False (no-op) when the camera already routes there."""
        src_idx = self.route_of(camera_id)
        self._check_broker(to_broker)
        if src_idx == to_broker:
            return False
        src, dst = self.brokers[src_idx], self.brokers[to_broker]
        if src.crashed or dst.crashed:
            raise RPCTimeout(
                f"migration endpoint down (brokers {src_idx}, {to_broker})")
        cam, tail, cursors = src.export_camera(camera_id, at=at)
        dst.adopt_camera(cam, replica_tail=tail)
        self._cam_route[camera_id] = to_broker
        # rebuild each affected herd subscription's part set: drop the
        # camera from its source part (closing parts left empty), create a
        # fresh part on the target with retarget=False (the controller
        # keeps its target and the carried PI integral), and import the
        # cursor so polling resumes in place
        for rec in self._subs.values():
            part = rec.part_of(camera_id)
            if part is None or part.broker != src_idx:
                continue
            part.cameras.remove(camera_id)
            if not part.cameras:
                # the broker already closed the emptied local record
                self._part_owner.pop((part.broker, part.sub_id), None)
                rec.parts.remove(part)
            sess = self._sessions[rec.session_id]
            opts = rec.options
            if opts is not None and opts.admission != "degrade":
                # a migrated lane is already admitted: it may be degraded
                # on the target but never re-rejected
                opts = dataclasses.replace(opts, admission="degrade")
            lsid = self._local_session(sess, to_broker)
            local = dst.create_subscription(lsid, [rec.specs[camera_id]],
                                            options=opts, retarget=False)
            dst.import_camera_cursor(local, camera_id,
                                     cursors[part.sub_id])
            new_part = _Part(to_broker, local, [camera_id])
            rec.parts.append(new_part)
            self._part_owner[(to_broker, local)] = rec.sub_id
            rec.events.append(SessionEvent(
                EventKind.CAMERA_MIGRATED, camera_id, rec.sub_id, at,
                f"broker {src_idx} -> {to_broker}"))
        self.migrations += 1
        return True

    # -- overload policy ---------------------------------------------------------------
    def broker_load(self, idx: int) -> dict:
        """One broker's watermark inputs: offered/budget wire ratio and the
        p95 of its recent delivered latencies (NaN with no samples)."""
        self._check_broker(idx)
        rep = self.brokers[idx].wire_report()
        budget = rep["budget_bps"]
        ratio = (rep["offered_bps"] / budget
                 if np.isfinite(budget) and budget > 0 else 0.0)
        window = self._lat_window[idx]
        p95 = float(np.percentile(window, 95)) if window else float("nan")
        return {"wire_ratio": ratio, "latency_p95": p95,
                "offered_bps": rep["offered_bps"], "budget_bps": budget}

    def overloaded(self, idx: int) -> bool:
        load = self.broker_load(idx)
        if load["wire_ratio"] > self.overload_ratio:
            return True
        return (self.latency_watermark is not None
                and not np.isnan(load["latency_p95"])
                and load["latency_p95"] > self.latency_watermark)

    def set_wire_budget(self, idx: int, budget: float | None) -> None:
        """Operator/scenario override of one broker's wire budget (e.g. a
        degraded backhaul); admission reallocates on the next join/leave,
        the herd's overload policy on the next ``rebalance``."""
        self._check_broker(idx)
        self.brokers[idx]._wire_budget = budget

    def rebalance(self, *, at: float = 0.0,
                  max_moves: int | None = None) -> list[tuple[str, int, int]]:
        """Shed load off every overloaded broker: migrate cameras of the
        newest lowest-priority SLO lanes first (admission's degradation
        order) to the least-loaded peer until the watermark clears or no
        sheddable lane remains.  Emits ``BROKER_OVERLOAD`` on each affected
        subscription.  Returns the ``(camera_id, from, to)`` moves made."""
        moves: list[tuple[str, int, int]] = []
        receivers: set[int] = set()
        for idx in range(len(self.brokers)):
            if self.brokers[idx].crashed or not self.overloaded(idx):
                continue
            if idx in receivers:
                # this broker absorbed shed lanes earlier in the pass:
                # shedding them straight back would ping-pong cameras
                # between mutually-overloaded brokers; the next rebalance
                # re-evaluates with settled loads
                continue
            load = self.broker_load(idx)
            wire_over = load["wire_ratio"] > self.overload_ratio
            trigger = (f"wire {load['wire_ratio']:.2f} > "
                       f"{self.overload_ratio:.2f}" if wire_over
                       else f"latency p95 {load['latency_p95'] * 1e3:.1f} ms")
            overloaded_subs = set()
            for hsub, camera_id in self._shed_candidates(idx):
                if max_moves is not None and len(moves) >= max_moves:
                    break
                # a wire-triggered shed only needs the move to reduce
                # imbalance (when the whole herd is past the watermark --
                # a degraded backhaul under saturation -- there IS no
                # non-overloaded peer, yet moving lanes toward the less
                # loaded broker still restores proportional service);
                # a latency-triggered shed keeps the stricter rule
                below = (self.broker_load(idx)["wire_ratio"] if wire_over
                         else None)
                target = self._least_loaded(exclude=idx, below=below)
                if target is None:
                    break
                if hsub.sub_id not in overloaded_subs:
                    overloaded_subs.add(hsub.sub_id)
                    hsub.events.append(SessionEvent(
                        EventKind.BROKER_OVERLOAD, camera_id, hsub.sub_id,
                        at, f"broker {idx}: {trigger}"))
                self.migrate_camera(camera_id, target, at=at)
                moves.append((camera_id, idx, target))
                receivers.add(target)
                self._lat_window[idx].clear()
                if not self.overloaded(idx):
                    break
        return moves

    def _shed_candidates(self, idx: int):
        """(herd sub, camera) pairs on broker ``idx`` in shed order:
        ascending (SLO priority, -seq) -- newest best_effort first -- then
        camera id for determinism.  Untenanted lanes are never shed."""
        ranked = []
        for rec in self._subs.values():
            for p in rec.parts:
                if p.broker != idx or not p.cameras:
                    continue
                entry = self.brokers[idx].wire_report()[
                    "subscriptions"].get(p.sub_id)
                if entry is None or entry["slo"] is None:
                    continue
                for cid in sorted(p.cameras):
                    ranked.append((entry["priority"], -rec.seq, cid, rec))
        ranked.sort(key=lambda t: t[:3])
        return [(rec, cid) for _, _, cid, rec in ranked]

    def _least_loaded(self, *, exclude: int,
                      below: float | None = None) -> int | None:
        """Least-loaded live peer.  With ``below`` set, any peer whose wire
        ratio sits strictly under it qualifies (relative balance); without
        it only a non-overloaded peer does (absolute watermark)."""
        best, best_ratio = None, None
        for i, b in enumerate(self.brokers):
            if i == exclude or b.crashed:
                continue
            ratio = self.broker_load(i)["wire_ratio"]
            if below is None:
                if self.overloaded(i):
                    continue
            elif ratio >= below:
                continue
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = i, ratio
        return best

    # -- rolling upgrade ---------------------------------------------------------------
    def rolling_upgrade(self, *, at: float = 0.0) -> int:
        """Restart every broker in turn with zero downtime: migrate its
        cameras to the least-loaded peer, crash + recover the emptied
        broker, then move on.  Cameras are NOT moved back -- the overload
        policy (or explicit migrations) rebalances afterwards.  Returns the
        number of migrations performed."""
        if len(self.brokers) < 2:
            raise ValueError("rolling upgrade needs at least two brokers")
        moved = 0
        for idx in range(len(self.brokers)):
            for camera_id in [cid for cid, b in self._cam_route.items()
                              if b == idx]:
                peers = [(self.broker_load(i)["wire_ratio"], i)
                         for i in range(len(self.brokers))
                         if i != idx and not self.brokers[i].crashed]
                if not peers:
                    raise RPCTimeout("no live peer to migrate onto")
                target = min(peers)[1]
                if self.migrate_camera(camera_id, target, at=at):
                    moved += 1
            self.brokers[idx].persist()
            self.brokers[idx].crash()
            self.brokers[idx].recover()
        return moved


class FederatedMezSystem:
    """Herd-backed drop-in for ``MezSystem``: same facade fields
    (``channel`` / ``edge`` / ``cams``), with ``edge`` a ``BrokerHerd`` --
    ``MezClient(system)`` and ``run_scenario`` work unchanged.  Runs on
    ``device`` (default ``"cuda"``), which raises without a CUDA device
    unless ``device="cpu"`` is asked for."""

    def __init__(self, channel: WirelessChannel, *, n_brokers: int = 2,
                 store: LogSegmentStore | None = None,
                 wire_budget: float | None = None,
                 overload_ratio: float = 0.95,
                 latency_watermark: float | None = None,
                 device: "str | torch.device | None" = None):
        self.channel = channel
        self.device = resolve_device(device)
        self.herd = BrokerHerd(n_brokers, store=store,
                               wire_budget=wire_budget,
                               overload_ratio=overload_ratio,
                               latency_watermark=latency_watermark,
                               device=self.device)
        self.edge = self.herd
        self.cams: dict[str, CamBroker] = {}

    def add_camera(self, camera_id: str, *, distance_m: float = 6.0,
                   fps: float = 5.0, broker: int | None = None) -> CamBroker:
        cam = CamBroker(camera_id, self.channel, distance_m=distance_m,
                        fps=fps, store=self.herd.store, device=self.device)
        self.cams[camera_id] = cam
        self.herd.register(cam, broker=broker)
        return cam
