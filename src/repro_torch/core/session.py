"""v2 client surface: ``MezClient`` -> ``Session`` -> ``Subscription``.

The paper's five-call API (Section 3.1) is single-camera and blocking; the
headline workload (Section 5.1) is five cameras feeding one detector.  This
module is the session-oriented client shape that matches that workload:

    client = MezClient(system)
    with client.open_session("app0", tenant="acme", slo="gold") as session:
        sub = session.subscribe(["cam0", "cam1"], 0.0, 8.0,
                                qos=QosBounds(latency=0.100, accuracy=0.95),
                                options=SubscriptionOptions(fleet=True))
        while (batch := sub.poll(max_frames=10)):
            payload, valid = batch.stack()        # jit-ready [B,H,W,C]
            ...
        sub.update_qos(latency=0.060)             # live renegotiation
        for ev in sub.events():                   # INFEASIBLE / RPC_TIMEOUT
            ...

Handles are thin: all state lives broker-side (``EdgeBroker`` session
registry), so a handle can be dropped and the registry stays authoritative
-- the same reasoning the paper uses to keep subscriber recovery trivial.

Configuration is a frozen ``SubscriptionOptions`` (``core.api``); the old
per-kwarg spelling (``controlled=``, ``fleet=``, ...) still works for one
release with a ``DeprecationWarning``.  Sessions opened under a tenant/SLO
class enter fleet-wide admission control (see ``EdgeBroker.wire_budget``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

from repro_torch.core.api import (FrameBatch, QosBounds, QosUpdate, SessionEvent,
                            SloClass, Status, SubscribeSpec,
                            SubscriptionOptions, SubscriptionState,
                            resolve_slo)

__all__ = ["MezClient", "Session", "Subscription"]

_UNSET = object()


class MezClient:
    """Entry point for the v2 API.  Wraps anything that implements the
    ``SessionedMessagingSystem`` protocol -- an ``EdgeBroker`` directly or a
    ``MezSystem`` facade (``system.edge`` is unwrapped automatically)."""

    def __init__(self, system):
        self._edge = getattr(system, "edge", system)

    def connect(self, url: str = "mez://edge") -> str:
        return self._edge.connect(url)

    def get_camera_info(self) -> list[str]:
        return self._edge.get_camera_info()

    def open_session(self, application_id: str, *,
                     tenant: str | None = None,
                     slo: SloClass | str | None = None) -> "Session":
        """Open a session, optionally under a tenant identity + SLO class
        (``"gold"`` / ``"silver"`` / ``"best_effort"`` or a custom
        ``SloClass``).  The pair becomes the default for every subscription
        the session creates and opts them into fleet-wide admission
        control."""
        return Session(self._edge,
                       self._edge.open_session(application_id, tenant=tenant,
                                               slo=slo),
                       application_id, tenant=tenant, slo=resolve_slo(slo))


class Session:
    """One application's conversation with the edge broker.  Context-manager;
    closing the session closes every subscription it created."""

    def __init__(self, edge, session_id: str, application_id: str, *,
                 tenant: str | None = None, slo: SloClass | None = None):
        self._edge = edge
        self.session_id = session_id
        self.application_id = application_id
        self.tenant = tenant
        self.slo = slo
        self._closed = False

    def subscribe(self, camera_ids: str | Sequence[str], t_start: float,
                  t_stop: float, *,
                  qos: QosBounds | None = None,
                  options: SubscriptionOptions | None = None,
                  latency: float | None = None,
                  accuracy: float | None = None,
                  controlled=_UNSET, feedback_window=_UNSET,
                  credit_limit=_UNSET, fleet=_UNSET, mesh=_UNSET,
                  auto_recharacterize=_UNSET,
                  drift_config=_UNSET) -> "Subscription":
        """Subscribe one or many cameras under shared QoS bounds; frames from
        all of them arrive timestamp-merged through one ``poll()``.

        Bounds come from ``qos`` (a ``QosBounds``); with a session-level SLO
        class and no explicit ``qos``, the class's (latency, accuracy) pair
        is used.  ``latency=``/``accuracy=`` floats are the deprecated
        spelling of ``qos`` and fold into it with a ``DeprecationWarning``
        when ``qos`` is not given.

        Everything else lives in ``options`` (a frozen
        ``SubscriptionOptions``); the individual kwargs (``controlled``,
        ``fleet``, ...) are deprecated and fold into ``options`` likewise.

        ``options.fleet`` runs the subscription's per-camera PI controllers
        as ONE batched device step per poll (the fleet control plane):
        per-poll control cost is ~flat in camera count, and per-camera QoS
        retargets / table refreshes hot-swap into the step's tables in
        place.  ``options.mesh`` must stay None: splitting the lanes
        over several GPUs is not ported yet.

        ``options.auto_recharacterize`` arms the drift-aware refresh loop
        (see ``EdgeBroker.create_subscription``); refreshes surface as
        ``TABLE_REFRESH`` events on ``events()``.
        """
        if isinstance(camera_ids, str):
            camera_ids = [camera_ids]
        opts = options if options is not None else SubscriptionOptions()
        legacy = {k: v for k, v in [("controlled", controlled),
                                    ("feedback_window", feedback_window),
                                    ("credit_limit", credit_limit),
                                    ("fleet", fleet),
                                    ("mesh", mesh),
                                    ("auto_recharacterize", auto_recharacterize),
                                    ("drift_config", drift_config)]
                  if v is not _UNSET}
        if legacy:
            warnings.warn(
                "passing {} to Session.subscribe is deprecated; use "
                "options=SubscriptionOptions(...)".format(
                    ", ".join(sorted(legacy))),
                DeprecationWarning, stacklevel=2)
            opts = dataclasses.replace(opts, **legacy)
        if qos is None and (latency is not None or accuracy is not None):
            if latency is not None and accuracy is not None:
                warnings.warn(
                    "passing latency=/accuracy= to Session.subscribe is "
                    "deprecated; use qos=QosBounds(latency, accuracy)",
                    DeprecationWarning, stacklevel=2)
                qos = QosBounds(latency, accuracy)
            else:
                raise ValueError("latency and accuracy must be given together"
                                 " (or use qos=QosBounds(...))")
        if qos is None:
            slo = (resolve_slo(opts.slo) if opts.slo is not None
                   else self.slo)
            if slo is None:
                raise ValueError(
                    "subscribe needs qos=QosBounds(...) (or a session/"
                    "options SLO class to default the bounds from)")
            qos = QosBounds(slo.max_latency, slo.min_accuracy)
        specs = tuple(SubscribeSpec(self.application_id, cid, t_start, t_stop,
                                    qos.latency, qos.accuracy)
                      for cid in camera_ids)
        sub_id = self._edge.create_subscription(self.session_id, specs,
                                                options=opts)
        return Subscription(self._edge, sub_id, tuple(camera_ids))

    def events(self) -> list[SessionEvent]:
        """Drain pending events across all of this session's subscriptions
        (plus session-level ones, e.g. ``ADMISSION_REJECTED``)."""
        return self._edge.session_events(self.session_id)

    def update_qos(self, *, latency: float | None = None,
                   accuracy: float | None = None,
                   recharacterize: bool = False) -> QosUpdate:
        """Renegotiate bounds across EVERY subscription of this session.

        With ``recharacterize=True`` each camera first re-sweeps its knob
        tables over its own recent frames (the batched grid engine runs in
        seconds, cheap enough to fold into a renegotiation) and hot-swaps
        them into its live controller before the new bounds are applied --
        online re-characterization, per the CANS self-configuration model.

        Returns ONE merged ``QosUpdate`` covering every subscription
        (``per_camera`` / ``subscription_ids`` carry the fan-out detail; it
        used to return a list).
        """
        updates = [self._edge.update_subscription_qos(
                       sid, latency=latency, accuracy=accuracy,
                       recharacterize=recharacterize)
                   for sid in self._edge.session_subscription_ids(
                       self.session_id)]
        merged = QosUpdate.merge(updates)
        if self.tenant or self.slo is not None:
            merged = dataclasses.replace(
                merged, tenant=self.tenant or "",
                slo_class=self.slo.name if self.slo else merged.slo_class)
        return merged

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> Status:
        if self._closed:
            return Status.OK
        self._closed = True
        return self._edge.close_session(self.session_id)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Subscription:
    """Handle for one (possibly multi-camera) subscription."""

    def __init__(self, edge, subscription_id: str, cameras: tuple[str, ...]):
        self._edge = edge
        self.subscription_id = subscription_id
        self.cameras = cameras
        self._closed = False

    def poll(self, max_frames: int = 16,
             deadline: float | None = None) -> FrameBatch:
        """Next ``FrameBatch``: at most ``max_frames`` timestamp-merged,
        at-most-once frames across all subscribed cameras.  Empty batch =>
        drained.  ``deadline`` (seconds) bounds the call's wall-clock time."""
        return self._edge.poll_subscription(self.subscription_id,
                                            max_frames=max_frames,
                                            deadline=deadline)

    def update_qos(self, *, latency: float | None = None,
                   accuracy: float | None = None,
                   recharacterize: bool = False) -> QosUpdate:
        """Renegotiate bounds live: per-camera controllers retarget in place,
        cursors/windows survive, no teardown or resubscribe.

        ``recharacterize=True`` additionally re-runs the batched knob-grid
        sweep on each camera's recent frames and hot-swaps the fresh tables
        into the live controller (and its device tables) before retargeting,
        so the new bounds are enforced against current conditions
        (``QosUpdate.recharacterized`` lists the cameras that re-swept).
        Same ``QosUpdate`` shape as ``Session.update_qos`` -- ``per_camera``
        carries the per-camera statuses.
        """
        return self._edge.update_subscription_qos(
            self.subscription_id, latency=latency, accuracy=accuracy,
            recharacterize=recharacterize)

    def events(self) -> list[SessionEvent]:
        """Drain this subscription's INFEASIBLE / RPC_TIMEOUT /
        TENANT_DEGRADED notifications."""
        return self._edge.subscription_events(self.subscription_id)

    @property
    def state(self) -> SubscriptionState:
        return self._edge.subscription_state(self.subscription_id)

    def close(self) -> Status:
        """Idempotent explicit teardown (broker record is evicted once;
        repeat closes are local no-ops)."""
        if self._closed:
            return Status.OK
        self._closed = True
        return self._edge.close_subscription(self.subscription_id)

    def frames(self, *, max_frames: int = 16):
        """Migration helper: drain as a flat v1-style frame iterator."""
        while True:
            batch = self.poll(max_frames=max_frames)
            if not batch:
                return
            yield from batch.frames

    def __enter__(self) -> "Subscription":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
