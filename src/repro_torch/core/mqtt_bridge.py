"""In-process MQTT-compatible bridge: the fleet's production on-ramp.

Real IoT camera fleets arrive over MQTT (FogMQ-style edge deployments), not
over Mez's internal ``CamBroker.publish`` API.  This module maps the MQTT
wire contract onto the Mez brokers without any external broker process or
client library:

* **Topic scheme** -- one topic per camera, ``mez/<camera_id>/frames``.
  Subscription filters support the standard MQTT wildcards (``+`` matches
  one level, ``#`` matches the remaining levels), so ``mez/+/frames`` and
  ``mez/#`` fan in the whole fleet.

* **Ingress** -- ``publish()`` appends the frame to the camera node's
  ``HostLog`` via ``CamBroker.publish``, exactly as a local camera would.
  The simulated ``WirelessChannel`` models latency but not loss, so the
  bridge adds a seeded Bernoulli loss model (``loss_rate``) for the MQTT
  hop; determinism is preserved for a fixed seed.

* **QoS mapped onto credit-based backpressure** -- every camera gets an
  ingress credit window (``ingress_credits``); an accepted publish consumes
  one credit and credits return when the egress side actually delivers that
  camera's frames to a subscriber (``pump()``) -- the same
  consume-on-demand discipline the brokers use between themselves.

  * **QoS 0** (at most once): one transmission; a lost frame, a crashed
    camera, or an empty credit window drops the publish (counted, never
    retried).
  * **QoS 1** (at least once): lost transmissions retransmit up to
    ``max_retries`` times.  A lost PUBACK retransmits a DUP publish which
    the camera log's ordering contract (append with ``timestamp <= last``
    is rejected) deduplicates -- the broker sees the frame once, the
    counter sees the duplicate.  With no credits (or a crashed camera) the
    message is queued and flushed when credits return / the camera heals,
    rather than dropped.

* **Egress** -- ``subscribe()`` opens real Mez subscriptions over the
  matching cameras and ``pump()`` drains their ``FrameBatch``es back out as
  topic messages, firing paho-style ``on_message`` callbacks.

The bridge holds no device of its own: it speaks the broker API, and the
brokers it fronts run on theirs.

Callbacks follow the paho-mqtt shapes (``on_publish(client, userdata,
mid)``, ``on_message(client, userdata, message)``) so the bridge can stand
in for a ``paho.mqtt.client.Client`` in publisher/subscriber code without a
network stack or the paho dependency.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque

import numpy as np

from repro_torch.core.api import (BrokerDown, SubscribeSpec,
                                  SubscriptionOptions)

__all__ = ["MqttBridge", "MqttMessage", "MqttMessageInfo", "topic_for",
           "parse_topic", "topic_matches", "MQTT_ERR_SUCCESS",
           "MQTT_ERR_AGAIN", "MQTT_ERR_NO_CONN", "MQTT_ERR_QUEUE_SIZE"]

# paho-mqtt return codes (the subset the bridge can produce)
MQTT_ERR_AGAIN = -1        # flow control: retry later (queued / gave up)
MQTT_ERR_SUCCESS = 0
MQTT_ERR_NO_CONN = 4       # unknown camera topic / camera node down
MQTT_ERR_QUEUE_SIZE = 15   # credit window empty, QoS 0 publish shed

TOPIC_PREFIX = "mez"
TOPIC_SUFFIX = "frames"
_FAR_FUTURE = 1e12         # egress subscriptions never self-expire


def topic_for(camera_id: str) -> str:
    """The frame topic of one camera: ``mez/<camera_id>/frames``."""
    return f"{TOPIC_PREFIX}/{camera_id}/{TOPIC_SUFFIX}"


def parse_topic(topic: str) -> str | None:
    """Camera id of a concrete (wildcard-free) frame topic, else None."""
    parts = topic.split("/")
    if (len(parts) == 3 and parts[0] == TOPIC_PREFIX
            and parts[2] == TOPIC_SUFFIX and parts[1]
            and "+" not in parts[1] and "#" not in parts[1]):
        return parts[1]
    return None


def topic_matches(topic_filter: str, topic: str) -> bool:
    """MQTT filter matching: ``+`` matches exactly one level, a trailing
    ``#`` matches the remaining levels (including zero)."""
    fparts = topic_filter.split("/")
    tparts = topic.split("/")
    for i, fp in enumerate(fparts):
        if fp == "#":
            return i == len(fparts) - 1
        if i >= len(tparts):
            return False
        if fp != "+" and fp != tparts[i]:
            return False
    return len(fparts) == len(tparts)


@dataclasses.dataclass(frozen=True)
class MqttMessage:
    """One message as seen by a subscriber callback (paho ``MQTTMessage``
    shape, with the payload as the frame array instead of raw bytes)."""
    topic: str
    payload: np.ndarray | None
    timestamp: float
    qos: int = 0
    mid: int = 0
    dup: bool = False


class MqttMessageInfo:
    """Result handle of one ``publish()`` (paho ``MQTTMessageInfo``)."""

    def __init__(self, mid: int, rc: int = MQTT_ERR_SUCCESS):
        self.mid = mid
        self.rc = rc
        self.attempts = 0          # transmissions actually made
        self.published = False     # frame landed in the camera log
        self.queued = False        # waiting for credits / camera recovery

    def is_published(self) -> bool:
        return self.published

    def __repr__(self) -> str:
        return (f"MqttMessageInfo(mid={self.mid}, rc={self.rc}, "
                f"published={self.published}, queued={self.queued}, "
                f"attempts={self.attempts})")


@dataclasses.dataclass
class _Egress:
    """One topic-filter subscription: a Mez subscription per matched camera
    (per-camera so only cameras with pending frames are polled -- polling an
    idle camera would read as end-of-stream and drain the cursor)."""
    topic_filter: str
    qos: int
    callback: object
    sub_ids: dict[str, str]        # camera_id -> Mez subscription id


class MqttBridge:
    """MQTT-compatible facade over a ``MezSystem`` / ``EdgeBroker``.

    ``loss_rate`` is the per-transmission Bernoulli loss probability of the
    MQTT hop (applied independently to the publish and to the PUBACK),
    drawn from a ``seed``-ed generator so runs are reproducible.
    ``ingress_credits`` is the per-camera credit window; ``max_retries``
    bounds QoS 1 retransmissions per publish.
    """

    def __init__(self, system, *, loss_rate: float = 0.0, seed: int = 0,
                 max_retries: int = 4, ingress_credits: int = 64):
        self._system = system
        self._edge = getattr(system, "edge", system)
        self.loss_rate = float(loss_rate)
        self.max_retries = int(max_retries)
        self.ingress_credits = int(ingress_credits)
        self._rng = np.random.default_rng(seed)
        self._mids = itertools.count(1)
        self._credits: dict[str, int] = {}
        self._pending: dict[str, int] = {}        # appended, not yet pumped
        self._queue: dict[str, deque] = {}        # QoS 1 awaiting credits
        self._auto_ts: dict[str, float] = {}
        self._returned_ts: dict[str, float] = {}  # credit-return watermark
        self._session_id: str | None = None
        self._egress: list[_Egress] = []
        self.userdata = None
        self.on_publish = None     # paho: fn(client, userdata, mid)
        self.on_message = None     # paho: fn(client, userdata, message)
        # counters (exposed via stats())
        self.published = 0
        self.delivered = 0
        self.dropped_qos0 = 0      # lost / shed / camera-down QoS 0 frames
        self.retries = 0           # QoS 1 retransmissions
        self.duplicates = 0        # DUP publishes deduped by the log
        self.give_ups = 0          # QoS 1 publishes out of retries
        self.queued_total = 0      # QoS 1 publishes parked for credits

    # -- helpers -----------------------------------------------------------------
    def _cam(self, camera_id: str):
        cams = getattr(self._system, "cams", None)
        if cams is not None and camera_id in cams:
            return cams[camera_id]
        return self._edge._cams.get(camera_id)

    def _lost(self) -> bool:
        return self.loss_rate > 0.0 and self._rng.random() < self.loss_rate

    def _credits_of(self, camera_id: str) -> int:
        return self._credits.setdefault(camera_id, self.ingress_credits)

    def _stamp(self, camera_id: str, timestamp: float | None) -> float:
        cam = self._cam(camera_id)
        if timestamp is None:
            step = 1.0 / (cam.fps if cam is not None else 5.0)
            timestamp = self._auto_ts.get(camera_id, -step) + step
        self._auto_ts[camera_id] = max(
            self._auto_ts.get(camera_id, timestamp), timestamp)
        return float(timestamp)

    # -- ingress -----------------------------------------------------------------
    def publish(self, topic: str, payload: np.ndarray, *, qos: int = 0,
                timestamp: float | None = None) -> MqttMessageInfo:
        """Publish one frame to a concrete camera topic.

        Returns a paho-style ``MqttMessageInfo``; inspect ``rc`` /
        ``is_published()`` rather than expecting an exception -- MQTT
        publishes fail soft.  ``timestamp`` defaults to a per-camera
        monotonic clock at the camera's fps.
        """
        if qos not in (0, 1):
            raise ValueError(f"unsupported qos {qos!r} (bridge speaks 0/1)")
        info = MqttMessageInfo(next(self._mids))
        camera_id = parse_topic(topic)
        if camera_id is None or self._cam(camera_id) is None:
            info.rc = MQTT_ERR_NO_CONN
            if qos == 0:
                self.dropped_qos0 += 1
            return info
        ts = self._stamp(camera_id, timestamp)
        if self._credits_of(camera_id) <= 0:
            if qos == 0:           # backpressure sheds best-effort traffic
                self.dropped_qos0 += 1
                info.rc = MQTT_ERR_QUEUE_SIZE
                return info
            self._enqueue(camera_id, ts, payload, info)
            return info
        self._transmit(camera_id, ts, payload, qos, info)
        return info

    def _enqueue(self, camera_id: str, ts: float, payload: np.ndarray,
                 info: MqttMessageInfo) -> None:
        info.queued = True
        self.queued_total += 1
        self._queue.setdefault(camera_id, deque()).append(
            (ts, payload, info))

    def _requeue_front(self, camera_id: str, ts: float, payload: np.ndarray,
                       info: MqttMessageInfo) -> None:
        """Re-park a message whose transmission found the camera down.

        It goes back to the FRONT of the queue -- it was dequeued first, so
        on recovery it must flush before anything parked behind it (QoS 1
        preserves publish order).  ``queued_total`` is not bumped again: the
        message was already counted when it first parked, and the log's
        monotonic-timestamp rule would reject the reordered replay a
        re-count would paper over."""
        info.queued = True
        self._queue.setdefault(camera_id, deque()).appendleft(
            (ts, payload, info))

    def _transmit(self, camera_id: str, ts: float, payload: np.ndarray,
                  qos: int, info: MqttMessageInfo, *,
                  from_queue: bool = False) -> None:
        """Run the (lossy) transmission state machine for one publish."""
        cam = self._cam(camera_id)
        attempts = 1 if qos == 0 else 1 + self.max_retries
        appended = False
        for attempt in range(attempts):
            info.attempts += 1
            if attempt > 0:
                self.retries += 1
            if self._lost():       # the PUB transmission itself was lost
                continue
            try:
                accepted = cam.publish(ts, payload)
            except BrokerDown:
                if qos == 0:
                    self.dropped_qos0 += 1
                    info.rc = MQTT_ERR_NO_CONN
                    return
                if from_queue:     # head-of-line again, ahead of newer parks
                    self._requeue_front(camera_id, ts, payload, info)
                else:              # fresh publish: parks behind older ones
                    self._enqueue(camera_id, ts, payload, info)
                return
            if accepted:
                appended = True
            elif appended:
                self.duplicates += 1   # DUP rejected by the ordering rule
            else:
                # out-of-order / non-monotonic timestamp: the log refuses
                # it and a retry can never succeed
                info.rc = MQTT_ERR_NO_CONN
                if qos == 0:
                    self.dropped_qos0 += 1
                return
            if qos == 0 or not self._lost():   # QoS 1: PUBACK direction
                break
            # PUBACK lost: sender must retransmit a DUP
        if not appended:
            if qos == 0:
                self.dropped_qos0 += 1
            else:
                self.give_ups += 1
            info.rc = MQTT_ERR_AGAIN
            return
        self._credits[camera_id] = self._credits_of(camera_id) - 1
        self._pending[camera_id] = self._pending.get(camera_id, 0) + 1
        self.published += 1
        info.published = True
        info.rc = MQTT_ERR_SUCCESS
        if self.on_publish is not None:
            self.on_publish(self, self.userdata, info.mid)

    def _flush(self, camera_id: str) -> None:
        """Deliver parked QoS 1 publishes while credits allow."""
        q = self._queue.get(camera_id)
        while q and self._credits_of(camera_id) > 0:
            ts, payload, info = q.popleft()
            info.queued = False
            self._transmit(camera_id, ts, payload, 1, info, from_queue=True)
            if info.queued:        # camera still down: it re-parked itself
                break

    def grant(self, camera_id: str, n: int = 1) -> None:
        """Manually return ``n`` ingress credits to a camera (an operator
        override of the pump-driven return path)."""
        self._credits[camera_id] = min(
            self.ingress_credits, self._credits_of(camera_id) + int(n))
        self._flush(camera_id)

    # -- egress ------------------------------------------------------------------
    def subscribe(self, topic_filter: str, callback=None,
                  qos: int = 0) -> tuple[int, int]:
        """Register an egress subscriber for every camera whose frame topic
        matches ``topic_filter`` (wildcards allowed).  Frames flow on
        ``pump()``; each is handed to ``callback`` (or the bridge-level
        ``on_message``) as an ``MqttMessage``.  Returns paho's
        ``(rc, mid)``."""
        mid = next(self._mids)
        matched = [cid for cid in self._edge.get_camera_info()
                   if topic_matches(topic_filter, topic_for(cid))]
        if not matched:
            return (MQTT_ERR_NO_CONN, mid)
        if self._session_id is None:
            self._session_id = self._edge.open_session("mqtt-bridge")
        sub_ids = {}
        for cid in matched:
            spec = SubscribeSpec("mqtt-bridge", cid, 0.0, _FAR_FUTURE,
                                 latency=0.250, accuracy=0.0)
            sub_ids[cid] = self._edge.create_subscription(
                self._session_id, (spec,),
                options=SubscriptionOptions(controlled=False),
                retarget=False)
        self._egress.append(_Egress(topic_filter, qos, callback, sub_ids))
        return (MQTT_ERR_SUCCESS, mid)

    def pump(self, max_frames: int = 16) -> list[MqttMessage]:
        """Drain pending frames to every subscriber and return the messages
        delivered this call.

        Only cameras with frames appended since the last pump are polled
        (an idle camera's empty poll would read as end-of-stream).  The
        first delivery of a frame returns its ingress credit -- closing the
        credit-based backpressure loop -- and unparks queued QoS 1
        publishes for that camera.
        """
        out: list[MqttMessage] = []
        for eg in self._egress:
            for cid, sub_id in eg.sub_ids.items():
                taken = 0
                # each poll opens one credit window (credit_limit frames);
                # keep polling while frames are pending and progress is made
                while self._pending.get(cid, 0) > 0 and taken < max_frames:
                    batch = self._edge.poll_subscription(
                        sub_id, max_frames=max_frames - taken)
                    if not batch:
                        break
                    taken += len(batch)
                    replenished = 0
                    for f in batch:
                        msg = MqttMessage(topic_for(cid), f.frame,
                                          f.timestamp, qos=eg.qos,
                                          mid=next(self._mids))
                        out.append(msg)
                        self.delivered += 1
                        cb = eg.callback or self.on_message
                        if cb is not None:
                            cb(self, self.userdata, msg)
                        # one credit back per frame, once across all
                        # subscribers (watermarked by timestamp)
                        if f.timestamp > self._returned_ts.get(cid, -np.inf):
                            self._returned_ts[cid] = f.timestamp
                            replenished += 1
                    if replenished:
                        self._pending[cid] = max(
                            0, self._pending.get(cid, 0) - replenished)
                        self._credits[cid] = min(
                            self.ingress_credits,
                            self._credits_of(cid) + replenished)
                        self._flush(cid)
        return out

    # -- introspection -----------------------------------------------------------
    def credits(self, camera_id: str) -> int:
        """Remaining ingress credits of one camera."""
        return self._credits_of(camera_id)

    def stats(self) -> dict:
        return {
            "published": self.published,
            "delivered": self.delivered,
            "dropped_qos0": self.dropped_qos0,
            "retries": self.retries,
            "duplicates": self.duplicates,
            "give_ups": self.give_ups,
            "queued_total": self.queued_total,
            "queued_now": sum(len(q) for q in self._queue.values()),
        }
