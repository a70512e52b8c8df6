"""The Mez API (paper Section 3.1, Fig. 7) - five calls:

    Connect(url) -> ID
    Publish(imageStream)
    GetCameraInfo() -> list[cameraIDs]
    Subscribe(applicationID, cameraID, tStart, tStop, latency, accuracy)
        -> imageStream
    Unsubscribe(applicationID, cameraID) -> status

Data model (Section 3.2): key-value pairs, key = frame timestamp, value =
frame, chronological order, at-most-once delivery (resend is an application-
level decision).

This module defines the wire-level records and the abstract interfaces the
Mez implementations and the NATS-like baseline share, so benchmarks can swap
systems.  Two client surfaces exist:

v1 (the paper's five calls): ``MessagingSystem`` -- blocking single-camera
pull iterators.  Kept working as a compat shim on top of v2.

v2 (session API): ``SessionedMessagingSystem`` -- a client opens a session,
subscribes one-or-many cameras per ``Subscription``, and drains frames in
timestamp-merged ``FrameBatch`` units sized for jitted detector batches.
QoS bounds renegotiate live via ``QosUpdate`` (no teardown/resubscribe), and
failures (``INFEASIBLE``, crashed brokers) surface on an event stream
instead of per-frame flags.  See ``repro_torch.core.session`` for the handle
classes (``MezClient`` / ``Session`` / ``Subscription``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, Protocol, Sequence

import numpy as np

__all__ = ["DeliveredFrame", "SubscribeSpec", "RPCTimeout", "BrokerDown",
           "MessagingSystem", "Status", "FrameBatch", "QosUpdate",
           "SubscriptionState", "SessionEvent", "EventKind",
           "SessionedMessagingSystem", "SloClass", "SLO_CLASSES",
           "resolve_slo", "QosBounds", "SubscriptionOptions",
           "AdmissionRejected", "CameraQosResult", "BoundedEventBuffer"]


class RPCTimeout(TimeoutError):
    """An RPC exceeded its deadline (the paper's failure-detection signal)."""


class BrokerDown(RuntimeError):
    """Raised by a crashed component when invoked (manifests as RPCTimeout at
    the caller after the deadline)."""


class Status(enum.Enum):
    OK = "ok"
    FAIL = "fail"
    INFEASIBLE = "infeasible"     # latency/accuracy bounds can't both be met


class AdmissionRejected(RuntimeError):
    """Fleet-wide admission control rejected a subscription: the aggregate
    wire budget cannot fit the newcomer's accuracy-floor demand even after
    degrading every lower-priority tenant to its floor (raised only under
    ``SubscriptionOptions(admission="reject")``; the default ``"degrade"``
    policy admits at a capped budget instead)."""

    def __init__(self, message: str, *, demand_bps: float = 0.0,
                 budget_bps: float = 0.0) -> None:
        super().__init__(message)
        self.demand_bps = demand_bps
        self.budget_bps = budget_bps


# =============================================================================
# Multi-tenant SLO classes + subscription configuration
# =============================================================================


@dataclasses.dataclass(frozen=True)
class SloClass:
    """A per-tenant service class: default QoS bounds plus a preemption
    priority.  Under fleet-wide oversubscription, admission control degrades
    lower-priority classes first (``best_effort`` before ``silver`` before
    ``gold``); a class is never degraded to make room for a lower or equal
    priority newcomer."""
    name: str
    max_latency: float             # default latency upper bound, seconds
    min_accuracy: float            # default accuracy floor, normalized F1
    priority: int                  # higher = preempted later


SLO_CLASSES: dict[str, SloClass] = {
    "gold": SloClass("gold", max_latency=0.050, min_accuracy=0.95,
                     priority=2),
    "silver": SloClass("silver", max_latency=0.100, min_accuracy=0.92,
                       priority=1),
    "best_effort": SloClass("best_effort", max_latency=0.250,
                            min_accuracy=0.80, priority=0),
}


def resolve_slo(slo: "SloClass | str | None") -> "SloClass | None":
    """Accept a class name (``"gold"``), an ``SloClass``, or ``None``."""
    if slo is None or isinstance(slo, SloClass):
        return slo
    try:
        return SLO_CLASSES[slo]
    except KeyError:
        raise ValueError(f"unknown SLO class {slo!r}; expected one of "
                         f"{sorted(SLO_CLASSES)} or an SloClass") from None


@dataclasses.dataclass(frozen=True)
class QosBounds:
    """The (latency upper bound, accuracy lower bound) pair of a
    subscription -- the paper's two Subscribe() QoS arguments."""
    latency: float                 # seconds
    accuracy: float                # normalized F1


@dataclasses.dataclass(frozen=True)
class SubscriptionOptions:
    """Everything about a subscription that is not a QoS bound.

    Replaces the kwarg sprawl on ``Session.subscribe`` /
    ``EdgeBroker.create_subscription`` (the legacy kwargs keep working for
    one release behind a ``DeprecationWarning``).  Frozen so a spec can be
    shared across scenario runs and threads without defensive copies.
    """
    controlled: bool = True        # run the latency controller
    feedback_window: int = 8       # latency samples fed back per poll
    credit_limit: int = 2          # per-camera in-flight frame credits
    fleet: bool = False            # one fused compiled tick for all lanes
    mesh: object = None            # multi-GPU lane split: not ported, None only
    auto_recharacterize: bool = False  # drift-triggered table re-sweeps
    drift_config: object = None    # DriftConfig override
    tenant: str | None = None      # tenant identity (defaults to session's)
    slo: "SloClass | str | None" = None  # service class (name or instance)
    admission: str = "degrade"     # oversubscription policy:
                                   #   "degrade" -> cap budgets, admit
                                   #   "reject"  -> raise AdmissionRejected


@dataclasses.dataclass(frozen=True)
class LatencyBreakdown:
    """Per-frame component latencies, seconds (paper Fig. 16)."""
    publish_api: float = 0.0
    controller: float = 0.0        # knob decision + frame modification
    log_copy: float = 0.0          # camera-node log -> transmit buffer
    network: float = 0.0           # wireless transfer
    broker_processing: float = 0.0 # edge-side append + dispatch
    subscribe_api: float = 0.0

    @property
    def total(self) -> float:
        return (self.publish_api + self.controller + self.log_copy
                + self.network + self.broker_processing + self.subscribe_api)


@dataclasses.dataclass(frozen=True)
class DeliveredFrame:
    camera_id: str
    timestamp: float
    frame: np.ndarray | None       # None => dropped (at-most-once + knob5)
    wire_bytes: int
    latency: LatencyBreakdown
    knob_index: int                # -1 = unmodified
    infeasible: bool = False


@dataclasses.dataclass(frozen=True)
class SubscribeSpec:
    application_id: str
    camera_id: str
    t_start: float
    t_stop: float                  # may be in the future (paper Section 3.1)
    latency: float                 # upper bound, seconds
    accuracy: float                # lower bound, normalized F1


class MessagingSystem(Protocol):
    def connect(self, url: str) -> str: ...
    def get_camera_info(self) -> list[str]: ...
    def subscribe(self, spec: SubscribeSpec) -> Iterator[DeliveredFrame]: ...
    def unsubscribe(self, application_id: str, camera_id: str) -> Status: ...


# =============================================================================
# v2 session API records
# =============================================================================


class SubscriptionState(enum.Enum):
    ACTIVE = "active"       # at least one camera still serving frames
    DRAINED = "drained"     # every camera exhausted its [t_start, t_stop]
    FAILED = "failed"       # no camera active and at least one crashed
    CLOSED = "closed"       # explicitly closed (idempotent)


class EventKind(enum.Enum):
    INFEASIBLE = "infeasible"      # controller: bounds can't both be met
    RPC_TIMEOUT = "rpc_timeout"    # camera node crashed / unreachable
    TABLE_REFRESH = "table_refresh"  # drift monitor auto-recharacterized a
                                     # camera's knob tables (detail says
                                     # whether the re-sweep succeeded)
    ADMISSION_REJECTED = "admission_rejected"  # fleet wire budget can't fit
                                               # the subscription (session-
                                               # level event)
    TENANT_DEGRADED = "tenant_degraded"  # admission control capped this
                                         # subscription's wire budget below
                                         # its nominal demand
    EVENTS_DROPPED = "events_dropped"  # the bounded event buffer evicted
                                       # undrained events since the last
                                       # drain (detail carries the count)
    BROKER_OVERLOAD = "broker_overload"  # a federated broker crossed its
                                         # wire-budget / poll-latency
                                         # watermark; the herd is shedding
                                         # lanes off it (detail names the
                                         # broker and the trigger)
    CAMERA_MIGRATED = "camera_migrated"  # the herd moved this camera to
                                         # another broker (detail carries
                                         # "broker i -> j"); polling
                                         # continues transparently


@dataclasses.dataclass(frozen=True)
class SessionEvent:
    """Out-of-band notification on a subscription's event stream (v2 replaces
    the v1 pattern of burying failures in per-frame flags / raised mid-
    iteration exceptions)."""
    kind: EventKind
    camera_id: str
    subscription_id: str
    timestamp: float               # stream position when the event fired
    detail: str = ""


class BoundedEventBuffer:
    """Bounded event queue for a subscription's / session's out-of-band
    notifications.

    Mirrors ``HostLog``'s evict-before-overwrite contract: at capacity the
    OLDEST undrained event is evicted first -- never silently overwritten in
    place -- and every eviction is counted.  A client that polls forever but
    never drains ``events()`` therefore costs O(capacity) memory, not O(run
    length), and the loss is *observable*: the next ``drain()`` call returns
    one ``EVENTS_DROPPED`` marker event ahead of the surviving events, with
    the eviction count since the previous drain in ``detail``.

    ``owner`` is the subscription/session id stamped on marker events (set
    by the broker right after the owning record is created).
    """

    def __init__(self, capacity: int = 256, owner: str = ""):
        self.capacity = int(capacity)
        self.owner = owner
        self._events: list[SessionEvent] = []
        self.dropped = 0             # lifetime evictions
        self._dropped_pending = 0    # evictions since the last drain
        self._last_evicted_ts = 0.0

    def append(self, event: SessionEvent) -> None:
        if len(self._events) >= self.capacity:
            evicted = self._events.pop(0)
            self._last_evicted_ts = evicted.timestamp
            self.dropped += 1
            self._dropped_pending += 1
        self._events.append(event)

    def drain(self) -> list[SessionEvent]:
        """Hand over (and clear) the pending events; when evictions happened
        since the last drain, the first returned event is an
        ``EVENTS_DROPPED`` marker accounting for them."""
        out, self._events = self._events, []
        if self._dropped_pending:
            out.insert(0, SessionEvent(
                EventKind.EVENTS_DROPPED, "", self.owner,
                self._last_evicted_ts,
                f"{self._dropped_pending} events evicted before drain "
                f"(buffer capacity {self.capacity})"))
            self._dropped_pending = 0
        return out

    def clear(self) -> None:
        self._events.clear()

    def __len__(self) -> int:
        return len(self._events)

    def __iter__(self):
        return iter(self._events)


@dataclasses.dataclass(frozen=True)
class CameraQosResult:
    """Per-camera outcome of one QoS renegotiation."""
    camera_id: str
    status: Status
    recharacterized: bool = False


@dataclasses.dataclass(frozen=True)
class QosUpdate:
    """Result of a live QoS renegotiation.

    One shape for both surfaces: ``Subscription.update_qos`` returns an
    update covering one subscription, ``Session.update_qos`` returns ONE
    merged update covering every subscription in the session (it used to
    return a list).  ``per_camera`` carries the per-camera results,
    ``subscription_ids`` the subscriptions touched, and ``tenant`` /
    ``slo_class`` the tenant identity the renegotiation ran under.
    """
    latency: float                 # new upper bound, seconds
    accuracy: float                # new lower bound, normalized F1
    status: Status
    applied_cameras: tuple[str, ...]
    subscription_id: str = ""
    # cameras whose characterization tables were re-swept online as part of
    # this renegotiation (``update_qos(recharacterize=True)``)
    recharacterized: tuple[str, ...] = ()
    per_camera: tuple[CameraQosResult, ...] = ()
    tenant: str = ""
    slo_class: str = ""
    subscription_ids: tuple[str, ...] = ()

    @classmethod
    def merge(cls, updates: "Sequence[QosUpdate]") -> "QosUpdate":
        """Fold per-subscription updates into one session-level update."""
        if not updates:
            return cls(0.0, 0.0, Status.FAIL, (), subscription_ids=())
        applied: list[str] = []
        rechar: list[str] = []
        per_cam: list[CameraQosResult] = []
        for u in updates:
            applied.extend(c for c in u.applied_cameras if c not in applied)
            rechar.extend(c for c in u.recharacterized if c not in rechar)
            per_cam.extend(u.per_camera)
        status = (Status.OK if any(u.status is Status.OK for u in updates)
                  else updates[0].status)
        head = updates[0]
        return cls(head.latency, head.accuracy, status, tuple(applied),
                   subscription_id=head.subscription_id,
                   recharacterized=tuple(rechar),
                   per_camera=tuple(per_cam),
                   tenant=head.tenant, slo_class=head.slo_class,
                   subscription_ids=tuple(u.subscription_id
                                          for u in updates))


@dataclasses.dataclass(frozen=True)
class FrameBatch:
    """One ``poll()`` result: timestamp-merged, at-most-once frames from all
    cameras of a subscription.

    ``frames`` is sorted by (timestamp, camera_id) and may include dropped
    frames (``frame is None`` -- knob5 / at-most-once).  ``stack()`` produces
    a dense float32 payload suitable for a jitted batched detector.
    """
    frames: tuple[DeliveredFrame, ...]
    subscription_id: str = ""

    def __len__(self) -> int:
        return len(self.frames)

    def __bool__(self) -> bool:
        return bool(self.frames)

    def __iter__(self) -> Iterator[DeliveredFrame]:
        return iter(self.frames)

    @property
    def delivered(self) -> tuple[DeliveredFrame, ...]:
        """Frames that carry a payload (dropped frames excluded)."""
        return tuple(f for f in self.frames if f.frame is not None)

    @property
    def dropped(self) -> tuple[DeliveredFrame, ...]:
        return tuple(f for f in self.frames if f.frame is None)

    @property
    def timestamps(self) -> np.ndarray:
        return np.asarray([f.timestamp for f in self.frames], np.float64)

    @property
    def camera_ids(self) -> tuple[str, ...]:
        return tuple(f.camera_id for f in self.frames)

    @property
    def shapes(self) -> tuple[tuple[int, int], ...]:
        """True (H, W) of each delivered payload (pre-padding)."""
        return tuple(np.asarray(f.frame).shape[:2] for f in self.delivered)

    def stack(self, *, batch_size: int | None = None,
              dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
        """Stack delivered payloads into ``(payload, valid)``.

        ``payload`` is ``[B, Hmax, Wmax, Cmax]`` zero-padded (ragged knob-
        resized frames are padded to the batch max; grayscale is promoted to
        one channel); ``valid`` is a ``[B]`` bool mask.  ``batch_size`` pads
        the batch dimension to a fixed size so a jitted detector sees a
        stable shape across polls (no recompiles).
        """
        frames = [np.atleast_3d(np.asarray(f.frame)) for f in self.delivered]
        n = len(frames)
        b = batch_size if batch_size is not None else n
        if n > b:
            raise ValueError(f"batch_size={b} < {n} delivered frames; "
                             "poll with a smaller max_frames")
        if n == 0:
            return (np.zeros((b, 0, 0, 0), dtype), np.zeros((b,), bool))
        hmax = max(f.shape[0] for f in frames)
        wmax = max(f.shape[1] for f in frames)
        cmax = max(f.shape[2] for f in frames)
        out = np.zeros((b, hmax, wmax, cmax), dtype)
        for i, f in enumerate(frames):
            out[i, : f.shape[0], : f.shape[1], : f.shape[2]] = f
        valid = np.zeros((b,), bool)
        valid[:n] = True
        return out, valid


class SessionedMessagingSystem(Protocol):
    """v2 broker-side surface (what ``repro_torch.core.session.MezClient`` wraps)."""
    def connect(self, url: str) -> str: ...
    def get_camera_info(self) -> list[str]: ...
    def open_session(self, application_id: str) -> str: ...
    def close_session(self, session_id: str) -> Status: ...
    def create_subscription(self, session_id: str,
                            specs: Sequence[SubscribeSpec]) -> str: ...
    def poll_subscription(self, subscription_id: str, *,
                          max_frames: int = 16,
                          deadline: float | None = None) -> FrameBatch: ...
    def update_subscription_qos(self, subscription_id: str, *,
                                latency: float | None = None,
                                accuracy: float | None = None,
                                recharacterize: bool = False) -> QosUpdate: ...
    def close_subscription(self, subscription_id: str) -> Status: ...
    def subscription_events(self, subscription_id: str) -> list[SessionEvent]: ...
    def subscription_state(self, subscription_id: str) -> SubscriptionState: ...
