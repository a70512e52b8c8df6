"""Mez brokers (paper Section 4.1) + the NATS-like baseline (Section 5.2).

Topology (paper Fig. 8): one ``CamBroker`` per IoT camera node (owns the
node's in-memory log and the latency controller), one ``EdgeBroker`` on the
edge server (owns one replicated log per registered camera and implements the
subscriber-facing API).  Frames move camera-log -> edge-log *on demand* --
nothing crosses the wireless channel until a subscriber asks (this limits
channel interference and saves camera-node power).

Simulation model: the system runs single-process on a virtual clock.  Network
latency comes from ``WirelessChannel`` (calibrated to the paper's testbed);
controller/knob overheads are the *measured* knob pipeline cost models; broker
processing costs are small constants.  All components are deterministic given
seeds, which makes the controller's step response (paper Fig. 11) exactly
reproducible.

Fault tolerance (Section 4.4): crash flags on each component; RPCs against a
crashed component raise ``RPCTimeout`` after their deadline (detection is
piggybacked on streaming traffic -- no separate heartbeats); recovery
reconstructs logs from the CRC-checked ``LogSegmentStore``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import warnings
from collections import OrderedDict
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.api import (AdmissionRejected, BoundedEventBuffer, BrokerDown,
                            CameraQosResult, DeliveredFrame, EventKind,
                            FrameBatch, LatencyBreakdown, QosUpdate,
                            RPCTimeout, SessionEvent, SloClass, Status,
                            SubscribeSpec, SubscriptionOptions,
                            SubscriptionState, resolve_slo)
from repro_torch.core.channel import WirelessChannel
from repro_torch.core.characterization import CharacterizationTable, LatencyRegression
from repro_torch.core.controller import (ControlDecision, ControllerConfig,
                                         ControllerTables, FleetController,
                                         FleetTickResult, LatencyController,
                                         swap_tables)
from repro_torch.core.drift import DriftConfig, DriftMonitor, relative_size_error
from repro_torch.core import knobs as K
from repro_torch.core.knobs import wire_size
from repro_torch.core.log import HostLog, LogSegmentStore
from repro_torch.device import resolve_device
from repro_torch.kernels import frame_knobs as FK

__all__ = ["CamBroker", "EdgeBroker", "NatsLikeSystem", "MezSystem",
           "SharedFrameCache"]

# sentinel for deprecated create_subscription kwargs (None is meaningful)
_UNSET = object()

# Broker-side fixed costs (seconds) -- small constants in the paper's Fig. 16
# breakdown ("all processing delays inside the messaging system").
PUBLISH_API_COST = 0.4e-3
SUBSCRIBE_API_COST = 0.6e-3
BROKER_PROC_COST = 0.9e-3
LOG_COPY_COST_PER_MB = 8.0e-3      # frame copy between logs, per
                                   # workload-equivalent MB (paper
                                   # Fig. 16: ~half the controller
                                   # time is the log copy)
RPC_DEADLINE = 0.5                 # seconds of virtual time

# Online re-characterization / pre-screen knobs.
TABLE_CAPACITY = 512               # padded ControllerTables rows: tables of
                                   # any kept-set size share one shape, so a
                                   # swap is a buffer write
RECHAR_CLIP_LEN = 16               # log-tail frames per online re-sweep
PRESCREEN_SLACK = 1.25             # proxy overshoot tolerance vs the size
                                   # budget before stepping a setting down
PRESCREEN_MAX_CANDIDATES = 3       # bounded candidate walk per frame
DRIFT_ACTIVITY_FLOOR = 0.01        # activity-residual denominator floor
                                   # (fraction of pixels): sub-point
                                   # differences in changed-pixel fraction
                                   # are mover jitter, not a regime change
                                   # -- without the floor a near-static
                                   # calibration clip makes the RELATIVE
                                   # residual ill-conditioned


# the one refusal of a fleet mesh, shared by ``SubscriptionOptions.mesh`` and
# ``ScenarioSpec.mesh``
MESH_NOT_PORTED = (
    "mesh: splitting the fleet tick's lanes over several GPUs is not ported "
    "yet (ROADMAP Queue 1, fleet mesh and sharding); pass mesh=None")


class SharedFrameCache:
    """Fleet-shared degraded-frame cache, keyed ``(camera, timestamp,
    transform key)``.

    Promotion of ``CamBroker``'s per-camera payload cache to the edge: N
    tenants subscribed to the same camera at the same operating point pay
    ONE knob transform + deflate instead of N.  Entries are the same
    mutable ``[payload, wire_bytes|None]`` pairs the per-camera cache used
    (deflate still fills in lazily, only for frames actually shipped), so
    promotion changes cost accounting only -- never payload bytes.

    One instance lives on the ``EdgeBroker`` and is attached to every
    ``CamBroker`` at ``register()``; a camera invalidates exactly its own
    keys on background change / recovery / re-characterization.  Hit/miss
    counters feed the multi-tenant benchmark's hit-rate gate.

    Eviction is LRU: a ``get`` hit refreshes the entry's recency, so under
    sustained tenant churn the entries every still-subscribed tenant reuses
    each poll outlive the one-shot entries of departed tenants.  (Insertion-
    order eviction here made the hit rate dip during churn floods: the
    oldest-*inserted* entry is usually the hottest one.)
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._entries: OrderedDict[tuple, list] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple) -> list | None:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
        else:
            self.hits += 1
            self._entries.move_to_end(key)         # LRU: a hit is a use
        return entry

    def put(self, key: tuple, entry: list) -> None:
        if key in self._entries:
            self._entries.move_to_end(key)
        elif len(self._entries) >= self.capacity:  # bounded: LRU evict
            self._entries.popitem(last=False)
            self.evictions += 1
        self._entries[key] = entry

    def invalidate(self, camera_id: str) -> None:
        """Drop every entry of one camera (its transform inputs changed)."""
        stale = [k for k in self._entries if k[0] == camera_id]
        for k in stale:
            del self._entries[k]

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        return len(self._entries)


class CamBroker:
    """Broker + log + controller on one IoT camera node."""

    def __init__(self, camera_id: str, channel: WirelessChannel, *,
                 log_capacity: int = 2048, distance_m: float = 6.0,
                 fps: float = 5.0, store: LogSegmentStore | None = None,
                 device: "str | torch.device | None" = None):
        self.camera_id = camera_id
        # where re-characterization sweeps and the device tables live
        self.device = resolve_device(device)
        self.channel = channel
        self.distance_m = distance_m
        self.fps = fps
        self.log = HostLog(log_capacity, topic=camera_id)
        self.controller: LatencyController | None = None
        # device-tensor copy of the controller's tables, padded to
        # TABLE_CAPACITY: a device controller_step consumer reads these and
        # takes online re-characterization as a buffer write
        self.device_tables: ControllerTables | None = None
        # version counters are read by FleetController.sync from the poll
        # thread while re-characterization bumps them; one mutex covers both
        self._version_lock = threading.Lock()
        self.table_version = 0  # guarded-by: _version_lock
        # bumped on every retarget/set_target: a FleetController diffing
        # this counter knows when to rewrite the camera's params lane
        self.qos_version = 0    # guarded-by: _version_lock
        self.store = store
        self.crashed = False
        self._last_sent: np.ndarray | None = None
        self._background: np.ndarray | None = None
        self._bg_memo: K.TransformMemo | None = None
        # (timestamp, transform key) -> [payload, wire_bytes|None]: fan-out
        # of one camera to several subscriptions reuses the knob transform +
        # deflate instead of recomputing them per fetch (simulated latency
        # numbers are untouched -- the cost model still charges the camera's
        # per-frame modification overhead).  wire_bytes stays None until a
        # frame is actually shipped: the pre-screen only ever needs the
        # payload + proxy features, never exact deflate.
        self._payload_cache: dict[tuple, list] = {}
        # edge-attached shared degraded-frame cache (multi-tenant fan-out);
        # None until EdgeBroker.register(), then transforms are shared
        # across every camera/subscription of the edge
        self.shared_cache: SharedFrameCache | None = None
        # per-frame scene-activity fractions (knob5's change metric)
        # observed by fetch since the last drain -- the drift monitor's
        # second channel (bounded; drained per poll by _drift_tick).
        # _prev_frame tracks the last frame fetch PROCESSED (shipped or
        # dropped): an observation is recorded only when the comparison
        # base was the immediately preceding frame, so the statistic
        # matches the table's CONSECUTIVE-frame activity -- comparing
        # against an older last-sent frame (motion accumulated across
        # knob5 drops) would bias the residual upward on a quiet scene
        self._activity_obs: list[float] = []
        self._prev_frame: np.ndarray | None = None
        # last successful re-sweep's (log state, sweep params): a repeat
        # request over the SAME published frames (e.g. a session-level
        # update_qos fanning out over subscriptions sharing this camera)
        # is a no-op instead of a redundant grid sweep
        self._rechar_memo: tuple | None = None
        self.payload_cache_hits = 0
        self.infeasible_reported = 0
        self.prescreen_evals = 0
        self.prescreen_stepdowns = 0

    # -- background model (knob4 + subscriber-side degradation) ------------------
    @property
    def background(self) -> np.ndarray | None:
        return self._background

    @background.setter
    def background(self, bg: np.ndarray | None) -> None:
        self._background = bg
        self._bg_memo = K.TransformMemo(bg) if bg is not None else None
        self._clear_payload_cache()
        self._rechar_memo = None           # sweeps keyed the old background

    def _clear_payload_cache(self) -> None:
        """Invalidate this camera's cached transforms (private dict AND its
        keys in the edge-shared cache): the transform inputs changed."""
        self._payload_cache.clear()
        if self.shared_cache is not None:
            self.shared_cache.invalidate(self.camera_id)

    def degraded_background(self, setting: K.KnobSetting) -> np.ndarray | None:
        """The camera's background model pushed through ``setting``'s
        transform pipeline, memoized per (resolution, colorspace, blur).

        Subscribers run background subtraction against the received
        stream's statistics, so they need the background degraded exactly
        like the frames -- computing that once per knob setting instead of
        once per frame is the point of the memo (the paper's knob pipeline
        budget is <10 ms/frame; a redundant background transform alone
        costs ~2 ms)."""
        if self._bg_memo is None:
            return None
        return self._bg_memo.get(setting)

    # -- internal APIs (paper Fig. 9) -------------------------------------------
    def set_target(self, latency: float, accuracy: float,
                   table: CharacterizationTable,
                   regression: LatencyRegression,
                   config: ControllerConfig | None = None) -> None:
        if self.crashed:
            raise BrokerDown(self.camera_id)
        cfg = config or ControllerConfig(latency_target=latency,
                                         accuracy_target=accuracy)
        cfg = dataclasses.replace(cfg, latency_target=latency,
                                  accuracy_target=accuracy)
        self.controller = LatencyController(cfg, table, regression)
        self._install_device_tables(table)
        with self._version_lock:
            self.qos_version += 1
        self._rechar_memo = None           # externally supplied tables

    def _install_device_tables(self, table: CharacterizationTable) -> None:
        fresh = ControllerTables.from_table(
            table, capacity=max(TABLE_CAPACITY, len(table.settings)),
            device=self.device)
        self.device_tables = swap_tables(self.device_tables, fresh)
        with self._version_lock:
            self.table_version += 1
        # payloads cached under the superseded table are stale: a hot-swap
        # (set_target / staleness injection / recharacterize) may recalibrate
        # what a given (camera, ts, setting) key should serve, so a post-swap
        # hit must never return a pre-swap transform
        self._clear_payload_cache()

    def recharacterize(self, *, clip_len: int = RECHAR_CLIP_LEN,
                       min_accuracy: float | None = None,
                       include_artifact: bool | None = None,
                       detector_thresh: float = 28.0) -> bool:
        """Re-sweep the knob grid over this camera's OWN recent frames and
        hot-swap the result into the live controller (host + device
        tables).

        The clip is the log tail (what the camera actually published just
        now), the background is the installed model, and accuracies are
        normalized against the full-quality stream's detections -- no
        labels needed.  ``min_accuracy`` and ``include_artifact`` default
        to the LIVE table's own floor and knob4 coverage, so a routine
        ``update_qos(recharacterize=True)`` refreshes measurements without
        silently reshaping the controller's trade space.  Returns False
        (leaving the stale tables serving) when the broker has no
        controller/background yet, the log is too short, the camera
        geometry is outside the batched engine's coverage, or the re-sweep
        kept no settings.
        """
        if self.crashed:
            raise BrokerDown(self.camera_id)
        if self.controller is None or self._background is None:
            return False
        live = self.controller.table
        if min_accuracy is None:
            min_accuracy = getattr(live, "min_accuracy", 0.90)
        if include_artifact is None:
            include_artifact = getattr(live, "includes_artifact", False)
        memo_key = (self.log.appends, clip_len, min_accuracy,
                    include_artifact, detector_thresh)
        if memo_key == self._rechar_memo:
            return True          # tables already fresh for this log state
        clip = [f for _, f in self.log.tail(clip_len)]
        if len(clip) < 4:
            return False
        from repro_torch.core import grid_engine
        try:
            table, jt = grid_engine.refresh_tables(
                self._background, clip, min_accuracy=min_accuracy,
                include_artifact=include_artifact,
                detector_thresh=detector_thresh, capacity=TABLE_CAPACITY,
                device=self.device)
        except ValueError:
            return False         # odd geometry etc: keep the stale tables
        if not table.settings:
            return False
        self.controller.swap_table(table)
        self.device_tables = swap_tables(self.device_tables, jt)
        with self._version_lock:
            self.table_version += 1
        self._clear_payload_cache()
        self._rechar_memo = memo_key
        return True

    def inject_table_staleness(self, factor: float = 0.5) -> bool:
        """Fault injection: make the LIVE tables stale in place.

        Rescales the size axis of the installed characterization table by
        ``factor`` while keeping the accuracy claims -- exactly what a scene
        regime change does to a table characterized on the old regime (the
        recorded clip-median wire sizes stop predicting what the camera now
        ships).  The swap follows the online-refresh contract verbatim
        (``swap_table`` host-side + device tables + ``table_version`` bump,
        PI integral carried), so a fleet lane hot-swaps in place.
        The stale table drops its wire-size proxy (a stale proxy would
        silently fight the pre-screen) and clears the re-characterization
        memo so a drift-triggered refresh really re-sweeps.

        Used by the scenario DSL's ``TableStaleness`` event to exercise the
        drift monitor deterministically without a full scene change.
        Returns False when no controller is installed yet.
        """
        if self.crashed:
            raise BrokerDown(self.camera_id)
        if self.controller is None:
            return False
        live = self.controller.table
        stale = dataclasses.replace(
            live,
            sizes_sorted=live.sizes_sorted * factor,
            size_by_setting=live.size_by_setting * factor,
            proxy=None,
            source="stale-injected",
        )
        self.controller.swap_table(stale)
        self._install_device_tables(stale)
        self._rechar_memo = None
        return True

    def retarget(self, latency: float, accuracy: float) -> bool:
        """Renegotiate bounds on the LIVE controller (v2 ``update_qos``):
        no teardown, no resubscribe -- the PI loop keeps its tables and
        regression and re-seeds its operating point for the new targets.
        Returns False when no controller is installed yet."""
        if self.crashed:
            raise BrokerDown(self.camera_id)
        if self.controller is None:
            return False
        self.controller.set_target(latency, accuracy)
        with self._version_lock:
            self.qos_version += 1
        return True

    # -- Publish (camera -> camera-node log) -------------------------------------
    def publish(self, timestamp: float, frame: np.ndarray) -> bool:
        if self.crashed:
            raise BrokerDown(self.camera_id)
        return self.log.append(timestamp, frame)

    # -- on-demand transfer (camera log -> edge, through controller + channel) ---
    def fetch(self, t_start: float, t_stop: float, *,
              latency_feedback: float | None = None,
              controlled: bool = True,
              max_frames: int | None = None,
              decision: ControlDecision | None = None,
              budget_scale: float = 1.0
              ) -> list[DeliveredFrame]:
        """Serve the frames in [t_start, t_stop] across the wireless channel.

        ``latency_feedback`` is the subscriber-observed p95 latency of the
        previous window -- the controller's sensor input.  ``max_frames``
        bounds the batch so the subscriber's control loop samples latency at
        its configured interval (paper: "the network latency is measured
        again at the next sampling interval").  ``decision`` injects a
        pre-made control decision (the fleet-backed ``EdgeBroker`` computes
        decisions for ALL cameras of a session in one batched device step
        and hands each camera its lane) -- the host controller is then not
        consulted for this fetch.  ``budget_scale`` is the owning
        subscription's admission-control cap on the nominal operating size
        (1.0 outside multi-tenant oversubscription; the fleet path carries
        the same cap inside its params, so host/fleet parity holds).
        """
        if self.crashed:
            raise BrokerDown(self.camera_id)
        out: list[DeliveredFrame] = []
        knob_idx = -1
        controller_cost = 0.0
        setting = None
        infeasible = False
        if controlled and self.controller is not None and decision is not None:
            infeasible = decision.acted and not decision.feasible
            if infeasible:
                self.infeasible_reported += 1
            setting = decision.setting
            knob_idx = decision.setting_index
        elif controlled and self.controller is not None and latency_feedback is not None:
            decision = self.controller.update(latency_feedback, budget_scale)
            infeasible = not decision.feasible
            if infeasible:
                self.infeasible_reported += 1
            setting = decision.setting
            knob_idx = decision.setting_index
        elif controlled and self.controller is not None:
            setting = self.controller.current_setting
            knob_idx = self.controller._current

        for ts, frame in self.log.range_query(t_start, t_stop):
            if max_frames is not None and len(out) >= max_frames:
                break
            if setting is not None:
                eff_setting, eff_idx, entry = setting, knob_idx, None
                # one change-fraction pass serves both knob5's drop
                # decision and the drift monitor's activity observation --
                # the latter only when last-sent IS the preceding frame
                # (a consecutive-frame fraction, the table's statistic)
                frac = K.change_fraction(frame, self._last_sent)
                if frac is not None and self._last_sent is self._prev_frame:
                    self._activity_obs.append(frac)
                    if len(self._activity_obs) > 256:
                        del self._activity_obs[:-256]
                self._prev_frame = frame
                thresh = K.DIFF_THRESHOLDS[setting.diff]
                drop = thresh >= 0.0 and frac is not None and frac <= thresh
                if decision is not None and not drop:
                    # knob5 short-circuit: a frame the decision drops never
                    # pays the transform/pre-screen pipeline; the walk is
                    # pinned to the decision's diff axis, so `drop` stays
                    # valid for whatever setting the pre-screen picks
                    eff_setting, eff_idx, entry = self._prescreen(
                        ts, frame, decision)
                r = self._apply_knobs_cached(ts, frame, eff_setting,
                                             entry=entry, drop=drop)
                controller_cost = r.overhead_ms * 1e-3
                if r.frame is None:
                    out.append(DeliveredFrame(
                        self.camera_id, ts, None, 0,
                        LatencyBreakdown(controller=controller_cost),
                        eff_idx, infeasible))
                    continue
                self._last_sent = frame
                payload, nbytes, idx = r.frame, r.wire_bytes, eff_idx
            else:
                payload, nbytes, idx = frame, wire_size(frame), knob_idx
            net = self.channel.transfer(nbytes, fps=self.fps,
                                        distance_m=self.distance_m)
            copy = LOG_COPY_COST_PER_MB * (
                self.channel.scaled_bytes(payload.nbytes) / 1e6)
            out.append(DeliveredFrame(
                self.camera_id, ts, payload, nbytes,
                LatencyBreakdown(publish_api=PUBLISH_API_COST,
                                 controller=controller_cost,
                                 log_copy=copy, network=net),
                idx, infeasible))
        return out

    def _prescreen(self, ts: float, frame: np.ndarray,
                   decision) -> tuple[K.KnobSetting, int, list | None]:
        """Per-frame wire-size pre-screen of the controller's candidate.

        The characterization table's per-setting sizes are CLIP MEDIANS; the
        frame about to ship can compress far worse (a busy scene after a
        calm calibration clip) and blow the controller's size budget.  With
        a proxy-calibrated table (batched engine), the candidate payload's
        byte-delta features predict its deflate size for free, and an
        overshooting candidate steps down the table (largest smaller-size
        setting still above the accuracy bound) BEFORE exact deflate runs --
        the same CANS-style pre-selection the characterization sweep uses,
        now on the stream hot path.  Bounded walk; falls back to the
        controller's own choice when no proxy is installed.  Returns
        (setting, index, cache entry of the accepted payload) so the
        caller never re-walks the cache for the frame it ships.
        """
        table = self.controller.table
        # getattr: tables unpickled from pre-proxy benchmark caches lack
        # the field entirely -- treat them like reference-engine tables
        proxy = getattr(table, "proxy", None)
        setting, idx = decision.setting, decision.setting_index
        if (proxy is None or setting is None or idx < 0
                or not decision.acted or not decision.feasible):
            return setting, idx, None
        budget = float(decision.requested_size)
        floor = self.controller.config.accuracy_target
        entry = None
        for walk in range(PRESCREEN_MAX_CANDIDATES):
            entry = self._transform_cached(ts, frame, setting)
            payload = entry[0]
            self.prescreen_evals += 1
            if entry[1] is not None:
                est = float(entry[1])       # exact deflate already known
            else:
                feats = FK.proxy_features_host(payload)
                est = float(proxy.predict(setting.colorspace, payload.nbytes,
                                          feats, art=setting.artifact > 0))
            # stop on a fitting candidate, or ship the last-evaluated one
            # (never step to a setting we won't evaluate: the returned
            # entry must be the returned setting's payload)
            if (est <= budget * PRESCREEN_SLACK
                    or walk == PRESCREEN_MAX_CANDIDATES - 1):
                break
            down = table.step_down(idx, floor, diff=setting.diff)
            if down < 0:
                break
            idx = down
            setting = table.setting_for(idx)
            self.prescreen_stepdowns += 1
        return setting, idx, entry

    def _transform_cached(self, ts: float, frame: np.ndarray,
                          setting: K.KnobSetting) -> list:
        """The pure knob transform (knob4 -> colorspace -> resize -> blur)
        memoized per (timestamp, transform key); returns the mutable
        ``[payload, wire_bytes|None]`` cache entry.  Deflate is filled in
        lazily by ``_apply_knobs_cached`` only for frames actually shipped,
        so the pre-screen never pays zlib for rejected candidates."""
        key = (ts, setting.resolution, setting.colorspace, setting.blur,
               setting.artifact)
        if self.shared_cache is not None:
            entry = self.shared_cache.get((self.camera_id,) + key)
        else:
            entry = self._payload_cache.get(key)
        if entry is not None:
            self.payload_cache_hits += 1
            return entry
        out = frame
        mode = K.ARTIFACT_MODES[setting.artifact]
        if mode != "off":
            bg = (self.background if self.background is not None
                  else np.zeros_like(frame))
            out = K._artifact_removal(out, bg, mode)
        out = K.transform_frame(out, setting)
        entry = [out, None]
        if self.shared_cache is not None:
            self.shared_cache.put((self.camera_id,) + key, entry)
        else:
            if len(self._payload_cache) >= 512:       # bounded: ring-ish evict
                self._payload_cache.pop(next(iter(self._payload_cache)))
            self._payload_cache[key] = entry
        return entry

    def _apply_knobs_cached(self, ts: float, frame: np.ndarray,
                            setting: K.KnobSetting, *,
                            entry: list | None = None,
                            drop: bool | None = None) -> K.KnobResult:
        """``apply_knobs`` with the transformed payload memoized per
        (timestamp, transform key).

        The knob5 drop decision is stateful (it compares against this
        camera's last *sent* frame) and stays per-call; only the pure
        transform + deflate of a surviving frame is reused, so several
        subscriptions fanning out from one camera pay the image pipeline
        once.  ``fetch`` passes the ``drop`` decision it already computed
        for this (frame, diff threshold) so the O(H*W) differencing never
        runs twice, and ``entry`` lets the pre-screen hand over the cache
        entry it already resolved for ``setting`` (no second lookup, no
        inflated hit counter).  Numerically identical to calling
        ``apply_knobs`` directly.
        """
        if drop is None:
            drop = K.frame_difference(frame, self._last_sent,
                                      K.DIFF_THRESHOLDS[setting.diff])
        if drop:
            return K.KnobResult(None, 0, setting.overhead_ms)
        if entry is None:
            entry = self._transform_cached(ts, frame, setting)
        if entry[1] is None:
            entry[1] = wire_size(entry[0])
        return K.KnobResult(entry[0], entry[1], setting.overhead_ms)

    def drain_activity(self) -> list[float]:
        """Per-frame scene-activity fractions observed by ``fetch`` since
        the last drain (knob5's change metric on the RAW stream, so the
        signal survives even when every frame is knob5-dropped).  The drift
        monitor compares their mean against the live table's
        ``activity`` statistic; a camera fanned out to several
        subscriptions shares one observation stream (first drainer wins)."""
        out = self._activity_obs
        self._activity_obs = []
        return out

    # -- fault tolerance -----------------------------------------------------------
    def crash(self) -> None:
        self.crashed = True

    def persist(self) -> None:
        if self.store is not None:
            self.store.persist(self.log)

    def recover(self) -> None:
        """Reboot: reconstruct the log from CRC-valid on-disk segments."""
        if self.store is not None:
            restored = self.store.recover(self.camera_id)
            if restored is not None:
                self.log = restored
        self.crashed = False
        self._last_sent = None
        self._prev_frame = None
        self._clear_payload_cache()
        self._activity_obs.clear()


@dataclasses.dataclass
class _CamCursor:
    """Per-camera streaming state inside one subscription."""
    spec: SubscribeSpec
    cursor: float
    window: list[float] = dataclasses.field(default_factory=list)
    failed: bool = False
    drained: bool = False
    detached: bool = False
    # credits granted to an in-flight fetch and not yet handed back; stays
    # non-zero across a crash (the dead camera holds them) until
    # ``reattach_camera`` returns them or teardown writes them off
    credits_held: int = 0

    @property
    def active(self) -> bool:
        return not (self.failed or self.drained or self.detached)


@dataclasses.dataclass
class _Subscription:
    """Broker-side subscription record: one or many cameras, fan-in merged."""
    sub_id: str
    session_id: str
    application_id: str
    cameras: dict[str, _CamCursor]
    controlled: bool
    feedback_window: int
    credit_limit: int
    rr_offset: int = 0
    # bounded (evict-before-overwrite + dropped counter, surfacing an
    # EVENTS_DROPPED marker on drain); owner id is stamped at create time
    events: BoundedEventBuffer = dataclasses.field(
        default_factory=BoundedEventBuffer)
    # credit ledger: every fetch credit granted / handed back / written off
    # over this subscription's lifetime (held credits live on the cursors)
    credits_granted: int = 0
    credits_returned: int = 0
    credits_dropped: int = 0
    # fleet control plane: one batched device controller step drives all
    # cameras of the subscription (built lazily once every camera has a
    # live controller; None until then / when not requested)
    want_fleet: bool = False
    fleet: FleetController | None = None
    # drift-aware auto-recharacterization: one vectorized staleness monitor
    # per subscription, fed once per poll with each camera's observed
    # wire-size residuals; fired lanes re-sweep their own tables with no
    # operator call (None when not requested)
    drift: DriftMonitor | None = None
    # lanes that fired at the END of a poll; the re-sweep applies at the
    # START of the next poll so a batch the subscriber is still holding
    # never references a table swapped out from under it
    pending_refresh: list = dataclasses.field(default_factory=list)
    # cached round-robin order over active cameras, invalidated whenever a
    # camera's active flag flips (crash/fail, drain, detach, reattach) --
    # poll no longer re-sorts the registry every call
    active_order: list | None = None
    # fleet fast path: lane-ordered incremental feedback (per-fetch p95,
    # identical to the per-poll recomputation since feedback windows only
    # mutate inside ``_fetch_into``) and the previous poll's aggregated
    # drift residuals, consumed by the fused tick at the next poll's start
    lat_lane: np.ndarray | None = None
    lat_valid: np.ndarray | None = None
    drift_pending: tuple | None = None
    # multi-tenant serving: tenant identity + SLO class (None = untenanted,
    # exempt from admission control), the admission-control cap currently
    # applied to this subscription's wire budget, the full options record,
    # and a monotonic creation sequence (within one class, newer
    # subscriptions degrade before incumbents)
    tenant: str | None = None
    slo: SloClass | None = None
    budget_scale: float = 1.0
    options: SubscriptionOptions | None = None
    seq: int = 0

    def invalidate_active(self) -> None:
        self.active_order = None


@dataclasses.dataclass
class _Session:
    session_id: str
    application_id: str
    sub_ids: list[str] = dataclasses.field(default_factory=list)
    # session-level tenant identity / SLO class: the default for every
    # subscription the session opens (SubscriptionOptions can override)
    tenant: str | None = None
    slo: SloClass | None = None
    # session-level events (e.g. ADMISSION_REJECTED fires before the
    # subscription exists); drained by session_events alongside the
    # per-subscription streams; bounded like the per-subscription buffers
    events: BoundedEventBuffer = dataclasses.field(
        default_factory=BoundedEventBuffer)


class EdgeBroker:
    """Edge-server broker: camera registry + replicated logs + session-backed
    subscriptions.

    v2 surface (``SessionedMessagingSystem``): applications open a session,
    create subscriptions spanning one or many cameras, and drain frames with
    ``poll_subscription`` -- a timestamp-merged ``FrameBatch`` per call.
    Fan-in uses credit-based backpressure: each poll grants every camera a
    credit window of at most ``credit_limit`` frames, so no camera can have
    more than ``credit_limit`` frames in flight per poll -- one chatty
    camera can't starve the rest of the batch or flood the wireless channel.
    The next credit window opens only when the subscriber polls again,
    i.e. after it has consumed the previous batch.

    The v1 blocking iterator (``subscribe``) is a thin compat shim over the
    same machinery, with identical per-fetch feedback numerics.
    """

    def __init__(self, *, log_capacity: int = 4096,
                 store: LogSegmentStore | None = None,
                 wire_budget: float | None = None,
                 device: "str | torch.device | None" = None):
        # where fleet control planes and drift monitors run
        self.device = resolve_device(device)
        self._cams: dict[str, CamBroker] = {}
        self.replicas: dict[str, HostLog] = {}
        self._ids = itertools.count()
        self._sessions: dict[str, _Session] = {}
        self._subscriptions: dict[str, _Subscription] = {}
        # legacy (application_id, camera_id) -> sub_ids, for v1 unsubscribe
        self._sub_index: dict[tuple[str, str], list[str]] = {}
        self.log_capacity = log_capacity
        self.store = store
        self.crashed = False
        # multi-tenant serving: the shared degraded-frame cache every
        # registered camera transforms through, the aggregate wire budget
        # admission control allocates (None -> the shared channel's base
        # rate), and the mutex serializing admission decisions (two joins
        # racing one budget must not both be admitted against it)
        self.frame_cache = SharedFrameCache()
        self._wire_budget = wire_budget
        self._admission_lock = threading.Lock()
        # credit ledger of subscriptions already torn down (live ones carry
        # their own counters); credit_report() folds both together
        self._credit_totals = {"granted": 0, "returned": 0, "dropped": 0}

    # -- Mez API -------------------------------------------------------------------
    def connect(self, url: str) -> str:
        if self.crashed:
            raise RPCTimeout("EdgeBroker down")
        return f"client-{next(self._ids)}"

    def register(self, cam: CamBroker) -> None:
        """Internal API for IoT camera nodes (paper Section 4.1)."""
        if self.crashed:
            raise RPCTimeout("EdgeBroker down")
        self._cams[cam.camera_id] = cam
        self.replicas[cam.camera_id] = HostLog(self.log_capacity,
                                               topic=cam.camera_id)
        cam.shared_cache = self.frame_cache
        cam.channel.activate(cam.camera_id)

    def unregister(self, camera_id: str) -> None:
        cam = self._cams.pop(camera_id, None)
        if cam is not None:
            cam.channel.deactivate(camera_id)

    def get_camera_info(self) -> list[str]:
        if self.crashed:
            raise RPCTimeout("EdgeBroker down")
        return sorted(self._cams)

    # -- v2 session API ------------------------------------------------------------
    def open_session(self, application_id: str, *,
                     tenant: str | None = None,
                     slo: SloClass | str | None = None) -> str:
        """Open a session, optionally under a tenant identity + SLO class.

        ``tenant``/``slo`` become the defaults for every subscription the
        session creates (``SubscriptionOptions`` can override per
        subscription).  A session with an SLO class participates in
        fleet-wide admission control; untenanted sessions keep the exact
        pre-multi-tenant behavior."""
        if self.crashed:
            raise RPCTimeout("EdgeBroker down")
        sid = f"sess-{next(self._ids)}"
        self._sessions[sid] = _Session(sid, application_id, tenant=tenant,
                                       slo=resolve_slo(slo))
        self._sessions[sid].events.owner = sid
        return sid

    def close_session(self, session_id: str) -> Status:
        """Evict the session and every subscription it owns from the
        registry (a long-lived broker must not accumulate dead records);
        closing an unknown/already-closed session returns FAIL."""
        if self.crashed:
            raise RPCTimeout("EdgeBroker down")
        sess = self._sessions.pop(session_id, None)
        if sess is None:
            return Status.FAIL
        for sub_id in sess.sub_ids:
            self.close_subscription(sub_id)
        return Status.OK

    def create_subscription(self, session_id: str,
                            specs: Sequence[SubscribeSpec], *,
                            options: SubscriptionOptions | None = None,
                            retarget: bool = True,
                            controlled=_UNSET,
                            feedback_window=_UNSET,
                            credit_limit=_UNSET,
                            fleet=_UNSET,
                            mesh=_UNSET,
                            auto_recharacterize=_UNSET,
                            drift_config=_UNSET) -> str:
        """Register a (possibly multi-camera) subscription on a session.

        Configuration lives in a frozen ``SubscriptionOptions``; the
        individual kwargs (``controlled``, ``feedback_window``, ...) are
        deprecated and accepted for one release, folding into ``options``
        with a ``DeprecationWarning``.

        With ``retarget`` (the default), each spec's (latency, accuracy)
        bounds are pushed to the camera's live controller -- the paper's
        Subscribe call carries the QoS bounds, it doesn't just record them.
        The v1 shim opts out to preserve the seed API's exact behavior
        (bounds there are set out-of-band via ``CamBroker.set_target``).
        A camera that is crashed at create time is marked failed and
        surfaces on the event stream at the first poll.

        With ``options.fleet``, every poll drives ALL cameras of the
        subscription through ONE batched device controller step
        (``FleetController``) instead of one host PI update per camera --
        per-poll control-plane cost is ~flat in camera count.  Requires
        ``controlled``; cameras whose controllers are installed later join
        the fleet lazily at the first poll where every camera is ready.

        With ``options.auto_recharacterize``, a per-subscription
        ``DriftMonitor`` watches every camera's observed wire sizes against
        its live table's predictions; a camera whose windowed drift score
        crosses the hysteresis threshold is re-characterized from its own
        recent frames automatically (``CamBroker.recharacterize``) and the
        fresh tables hot-swap into the live controller -- and, in fleet
        mode, into exactly that camera's stacked lane -- with no operator
        call.  ``options.drift_config`` tunes the monitor;
        requires ``controlled``.  Each refresh (or failed re-sweep attempt)
        surfaces as a ``TABLE_REFRESH`` event on the subscription's event
        stream.

        A subscription whose effective SLO class (``options.slo``, falling
        back to the session's) is set enters fleet-wide admission control:
        its aggregate wire demand -- ``Regression^-1(latency)`` bytes/frame
        x fps summed over cameras, from the live characterization tables --
        is checked against ``wire_budget()``.  When the fleet is
        oversubscribed, lower SLO classes are degraded first
        (``TENANT_DEGRADED`` events, ``budget_scale`` < 1 on their control
        lanes); if even fully-degraded lanes cannot fit, the new
        subscription is rejected (``ADMISSION_REJECTED`` event +
        ``AdmissionRejected``) under ``options.admission == "reject"``, or
        admitted maximally degraded under ``"degrade"`` (the default).
        Subscriptions with no SLO class never degrade and never enter
        admission -- their behavior is byte-identical to the
        single-tenant system.
        """
        if self.crashed:
            raise RPCTimeout("EdgeBroker down")
        sess = self._sessions.get(session_id)
        if sess is None:
            raise RPCTimeout(f"unknown session {session_id}")
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
                "passing {} to create_subscription is deprecated; use "
                "options=SubscriptionOptions(...)".format(
                    ", ".join(sorted(legacy))),
                DeprecationWarning, stacklevel=2)
            opts = dataclasses.replace(opts, **legacy)
        if not specs:
            raise ValueError("subscription needs at least one camera spec")
        if opts.fleet and not opts.controlled:
            raise ValueError("fleet control plane requires controlled=True")
        if opts.mesh is not None:
            raise NotImplementedError(MESH_NOT_PORTED)
        if opts.auto_recharacterize and not opts.controlled:
            raise ValueError("auto_recharacterize requires controlled=True")
        if opts.admission not in ("degrade", "reject"):
            raise ValueError(f"unknown admission policy {opts.admission!r}")
        for spec in specs:
            if spec.camera_id not in self._cams:
                raise RPCTimeout(f"unknown camera {spec.camera_id}")
        tenant = opts.tenant if opts.tenant is not None else sess.tenant
        slo = resolve_slo(opts.slo) if opts.slo is not None else sess.slo
        num = next(self._ids)
        sub_id = f"sub-{num}"
        cameras = {spec.camera_id: _CamCursor(spec, spec.t_start)
                   for spec in specs}
        rec = _Subscription(sub_id, session_id, sess.application_id, cameras,
                            opts.controlled, opts.feedback_window,
                            opts.credit_limit, want_fleet=opts.fleet,
                            tenant=tenant, slo=slo,
                            options=opts, seq=num)
        rec.events.owner = sub_id
        if opts.auto_recharacterize:
            # lane order is the sorted camera-id order, matching the fleet
            # stack, so drift telemetry and fleet lanes line up.  With no
            # explicit config, each lane's hysteresis thresholds are
            # learned from its calibration clip's own residual spread
            # (``drift.learned_thresholds``; hand-set constants floor it).
            spreads = None
            if opts.drift_config is None:
                spreads = {}
                for cid in cameras:
                    ctl = self._cams[cid].controller
                    tbl = ctl.table if ctl is not None else None
                    spreads[cid] = getattr(tbl, "residual_spread", None)
            rec.drift = DriftMonitor(sorted(cameras), opts.drift_config,
                                     spreads=spreads, device=self.device)
        with self._admission_lock:
            admitting = slo is not None or any(
                r.slo is not None for r in self._subscriptions.values())
            if admitting and slo is not None:
                self._admission_check(rec, sess, opts.admission)
            if retarget:
                for spec in specs:
                    try:
                        self._cams[spec.camera_id].retarget(spec.latency,
                                                            spec.accuracy)
                    except BrokerDown as e:
                        cameras[spec.camera_id].failed = True
                        rec.events.append(SessionEvent(
                            EventKind.RPC_TIMEOUT, spec.camera_id, sub_id,
                            spec.t_start, str(e)))
            self._subscriptions[sub_id] = rec
            sess.sub_ids.append(sub_id)
            for spec in specs:
                self._sub_index.setdefault(
                    (sess.application_id, spec.camera_id), []).append(sub_id)
            if admitting:
                self._reallocate(at=min(s.t_start for s in specs))
        if opts.fleet:
            self._ensure_fleet(rec)      # build now if controllers are live
        return sub_id

    # -- fleet-wide admission control (multi-tenant serving) ---------------------
    def wire_budget(self) -> float:
        """Aggregate bytes/s the shared fleet may offer the wireless
        channel: an explicit ``EdgeBroker(wire_budget=...)`` override, else
        the shared channel's base rate."""
        if self._wire_budget is not None:
            return self._wire_budget
        for cam in self._cams.values():
            return cam.channel.config.base_rate
        return float("inf")

    def _lane_load(self, cam: CamBroker,
                   spec: SubscribeSpec) -> tuple[float, float] | None:
        """(demand_bps, floor_bps) for one camera lane of a subscription,
        from the camera's live characterization.

        demand: the wire rate the lane wants at full QoS -- the nominal
        operating size ``Regression^-1(latency)`` (clipped to the table's
        characterized range) x the camera's fps, workload-scaled like the
        channel's own cost model.  floor: the cheapest rate that still
        meets the spec's accuracy bound (the smallest characterized setting
        with ``acc >= accuracy``); a lane can be degraded down to its floor
        but never below.  None when the camera has no live controller yet
        (an uncharacterized lane cannot be costed -- it joins admission
        accounting at its first retarget/poll)."""
        ctl = cam.controller
        if ctl is None:
            return None
        tbl = ctl.table
        nominal = float(np.clip(ctl.regression.invert(spec.latency),
                                tbl.sizes_sorted[0], tbl.sizes_sorted[-1]))
        ok = tbl.size_by_setting[tbl.acc_by_setting >= spec.accuracy]
        floor = float(ok.min()) if ok.size else float(tbl.sizes_sorted[0])
        floor = min(floor, nominal)
        return (cam.channel.scaled_bytes(nominal) * cam.fps,
                cam.channel.scaled_bytes(floor) * cam.fps)

    def _sub_load(self, rec: _Subscription) -> tuple[float, float]:
        """Aggregate (demand_bps, floor_bps) over a subscription's active
        cameras."""
        demand = floor = 0.0
        for cid, cur in rec.cameras.items():
            if not cur.active or cur.failed:
                continue
            cam = self._cams.get(cid)
            if cam is None or cam.crashed:
                continue
            load = self._lane_load(cam, cur.spec)
            if load is not None:
                demand += load[0]
                floor += load[1]
        return demand, floor

    def _slo_subs(self) -> list[_Subscription]:
        return [r for r in self._subscriptions.values() if r.slo is not None]

    def _admission_check(self, rec: _Subscription, sess: _Session,
                         policy: str) -> None:
        """Reject ``rec`` if even the maximally-degraded fleet cannot fit
        it: its own floor + the demand admission may NOT touch (untenanted
        subscriptions, higher-priority classes at full rate is not
        required -- they too can degrade to floor, so only their floors are
        protected) must fit the wire budget."""
        budget = self.wire_budget()
        if not np.isfinite(budget):
            return
        _, floor_new = self._sub_load(rec)
        protected = 0.0
        for other in self._subscriptions.values():
            d, f = self._sub_load(other)
            # untenanted subscriptions never degrade: full demand protected
            protected += d if other.slo is None else f
        if floor_new + protected > budget:
            at = min(c.spec.t_start for c in rec.cameras.values())
            if policy == "reject":
                sess.events.append(SessionEvent(
                    EventKind.ADMISSION_REJECTED, "", rec.sub_id, at,
                    f"demand floor {floor_new + protected:.0f} B/s exceeds "
                    f"wire budget {budget:.0f} B/s"))
                raise AdmissionRejected(
                    f"subscription {rec.sub_id} (tenant={rec.tenant!r}, "
                    f"slo={rec.slo.name}) infeasible: floor "
                    f"{floor_new + protected:.0f} B/s > budget {budget:.0f} B/s",
                    demand_bps=floor_new + protected, budget_bps=budget)
            rec.events.append(SessionEvent(
                EventKind.TENANT_DEGRADED, "", rec.sub_id, at,
                "admitted over budget: fleet remains oversubscribed even "
                "fully degraded"))

    def _reallocate(self, at: float = 0.0) -> None:
        """Re-divide the wire budget across all SLO-classed subscriptions.

        Lower-priority classes absorb the shortfall first (``best_effort``
        before ``silver`` before ``gold``; newest-first within a class), by
        scaling each victim's nominal operating point
        (``budget_scale = (demand - cut) / demand``) down toward -- never
        below -- its accuracy floor.  Untenanted subscriptions are never
        touched; their demand is simply subtracted from the budget.  Scales
        are quantized to f32 so the host PI path and the fleet's
        params-lane path compute identical operating points.  Restores
        (scale moving back up, e.g. after a tenant leaves) are silent;
        decreases emit one ``TENANT_DEGRADED`` event per subscription.
        Caller holds ``_admission_lock``."""
        slo_subs = self._slo_subs()
        if not slo_subs:
            return
        budget = self.wire_budget()
        if not np.isfinite(budget):
            for r in slo_subs:
                self._apply_budget_scale(r, 1.0, at)
            return
        protected = sum(self._sub_load(r)[0]
                        for r in self._subscriptions.values()
                        if r.slo is None)
        loads = {r.sub_id: self._sub_load(r) for r in slo_subs}
        offered = protected + sum(d for d, _ in loads.values())
        excess = offered - budget
        # victims in ascending (priority, newest-first) order
        order = sorted(slo_subs, key=lambda r: (r.slo.priority, -r.seq))
        scales = {r.sub_id: 1.0 for r in slo_subs}
        for r in order:
            d, f = loads[r.sub_id]
            if d <= 0.0:
                # a dark subscription (every lane failed/crashed/detached)
                # offers nothing right now, but restoring it to full rate
                # here would leapfrog the reverse-degradation restore order:
                # when its cameras reattach it would run at scale 1.0 while
                # later-degraded higher classes are still cut.  Hold its
                # current scale; reattach_camera re-runs allocation.
                scales[r.sub_id] = r.budget_scale
                continue
            if excess <= 1e-9:
                continue
            cut = min(excess, d - f)
            if cut <= 0.0:
                continue
            scales[r.sub_id] = float(np.float32((d - cut) / d))
            excess -= cut
        for r in slo_subs:
            self._apply_budget_scale(r, scales[r.sub_id], at)

    def _apply_budget_scale(self, rec: _Subscription, scale: float,
                            at: float) -> None:
        """Install a budget scale on a subscription's control plane (host
        PI path via the per-poll ``budget_scale`` argument, fleet path via
        one params-leaf write -- no retrace either way)."""
        if scale == rec.budget_scale:
            return
        decreased = scale < rec.budget_scale
        rec.budget_scale = scale
        if rec.fleet is not None:
            rec.fleet.set_budget_scale(scale)
        if decreased:
            rec.events.append(SessionEvent(
                EventKind.TENANT_DEGRADED, "", rec.sub_id, at,
                f"tenant={rec.tenant!r} slo={rec.slo.name} "
                f"budget_scale={scale:.4f}"))

    def wire_report(self) -> dict:
        """Introspection: the admission controller's current allocation."""
        budget = self.wire_budget()
        subs = {}
        offered = 0.0
        for r in self._subscriptions.values():
            d, f = self._sub_load(r)
            offered += d * (r.budget_scale if r.slo is not None else 1.0)
            subs[r.sub_id] = {
                "tenant": r.tenant,
                "slo": r.slo.name if r.slo is not None else None,
                "priority": r.slo.priority if r.slo is not None else None,
                "demand_bps": d,
                "floor_bps": f,
                "scale": r.budget_scale if r.slo is not None else 1.0,
                "allocated_bps": d * (r.budget_scale
                                      if r.slo is not None else 1.0),
            }
        return {"budget_bps": budget, "offered_bps": offered,
                "subscriptions": subs}

    def credit_report(self) -> dict:
        """Introspection: the fleet-wide credit ledger (live subscriptions
        plus everything already torn down).

        ``in_flight`` is what crashed-but-not-reattached cameras currently
        hold; ``dropped`` is what teardown/detach wrote off; ``leaked`` is
        the conservation residual ``granted - returned - in_flight -
        dropped`` and must be 0 -- the gauntlet gates on it."""
        granted = self._credit_totals["granted"]
        returned = self._credit_totals["returned"]
        dropped = self._credit_totals["dropped"]
        in_flight = 0
        for r in self._subscriptions.values():
            granted += r.credits_granted
            returned += r.credits_returned
            dropped += r.credits_dropped
            in_flight += sum(c.credits_held for c in r.cameras.values())
        return {"granted": granted, "returned": returned,
                "in_flight": in_flight, "dropped": dropped,
                "leaked": granted - returned - in_flight - dropped}

    def _ensure_fleet(self, rec: _Subscription) -> FleetController | None:
        """Build the subscription's fleet control plane once every camera
        has a live controller; until then polls fall back to the per-camera
        host path.  Lane order is the sorted camera-id order (stable across
        polls and restarts)."""
        if rec.fleet is not None or not rec.want_fleet:
            return rec.fleet
        cams = []
        for cid in sorted(rec.cameras):
            cam = self._cams.get(cid)
            if cam is None or cam.controller is None:
                return None
            cams.append(cam)
        rec.fleet = FleetController(cams, capacity=TABLE_CAPACITY,
                                    tier=rec.slo.priority if rec.slo else 0,
                                    device=self.device)
        if rec.budget_scale != 1.0:
            rec.fleet.set_budget_scale(rec.budget_scale)
        if rec.drift is not None:
            rec.fleet.attach_drift(rec.drift)
        # lane-ordered incremental feedback, seeded from whatever the host
        # path accumulated before the fleet went live (lazy join)
        n = len(cams)
        rec.lat_lane = np.zeros(n, np.float32)
        rec.lat_valid = np.zeros(n, bool)
        for i, cid in enumerate(rec.fleet.cam_ids):
            w = rec.cameras[cid].window
            if w:
                rec.lat_lane[i] = np.percentile(w, 95)
                rec.lat_valid[i] = True
        return rec.fleet

    def _active_order(self, rec: _Subscription) -> list:
        """The sorted active-camera round-robin base order, cached until a
        camera's active flag flips (``_Subscription.invalidate_active``)."""
        if rec.active_order is None:
            rec.active_order = [cid for cid in sorted(rec.cameras)
                                if rec.cameras[cid].active]
        return rec.active_order

    # mezlint: poll-path
    def poll_subscription(self, subscription_id: str, *,
                          max_frames: int = 16,
                          deadline: float | None = None) -> FrameBatch:
        """Drain up to ``max_frames`` timestamp-merged frames from all active
        cameras of the subscription (at-most-once: a fetched frame is never
        re-fetched).

        Each active camera is visited once per poll (round-robin rotated for
        fairness), fetching at most ``min(credits, share)`` frames where
        share divides ``max_frames`` across cameras; per-fetch the camera's
        own p95-latency window is fed back to its controller, exactly as the
        v1 single-camera loop did.  ``deadline`` bounds the poll's wall-clock
        time.  A crashed camera is marked failed and surfaces as an
        RPC_TIMEOUT event while the remaining cameras keep streaming; only
        when every camera has failed does poll raise ``RPCTimeout``.
        An empty batch means the subscription is drained (or closed).
        """
        if self.crashed:
            raise RPCTimeout("EdgeBroker down")
        rec = self._subscriptions.get(subscription_id)
        if rec is None:
            return FrameBatch((), subscription_id)
        fleet = self._ensure_fleet(rec) if rec.controlled else None
        self._apply_pending_refreshes(rec)
        t0 = time.monotonic()
        active = self._active_order(rec)
        out: list[DeliveredFrame] = []
        decisions = None
        if fleet is not None and (active or rec.drift is not None):
            # ONE fused device tick per poll: the controller step for
            # every serving camera, the drift-monitor tick on the residuals
            # aggregated at the END of the previous poll, and the
            # decision->knob-code application, in a single call.  Fired
            # drift lanes re-characterize on the host and the SAME tick
            # re-decides against the fresh tables -- so the host side does
            # I/O and bookkeeping only.  Note the tick covers every serving
            # camera even when a saturated ``max_frames`` ends the fetch
            # loop early; with the default share/credit sizing every camera
            # is fetched each poll and fused decisions match the host path
            # exactly.
            decisions = self._fleet_tick(rec, fleet, active)
        if active:
            k = rec.rr_offset % len(active)
            rec.rr_offset += 1
            order = active[k:] + active[:k]
            share = max(1, max_frames // len(order))
            for cid in order:
                if len(out) >= max_frames:
                    break
                # the deadline never forges an end-of-stream: an empty batch
                # must mean drained, so expiry only stops a poll that has
                # already made progress
                if (out and deadline is not None
                        and time.monotonic() - t0 > deadline):
                    break
                self._fetch_into(rec, cid, min(share, max_frames - len(out)),
                                 out,
                                 decision=(decisions.get(cid)
                                           if decisions is not None else None))
        out.sort(key=lambda d: (d.timestamp, d.camera_id))
        self._drift_tick(rec, out, fused=fleet is not None)
        if not out:
            cams = rec.cameras.values()
            if any(c.failed for c in cams) and all(
                    c.failed or c.detached for c in cams):
                raise RPCTimeout(
                    f"all cameras of {subscription_id} unreachable")
        return FrameBatch(tuple(out), subscription_id)

    # mezlint: poll-path
    def _fleet_tick(self, rec: _Subscription, fleet: FleetController,
                    active: list) -> "FleetTickResult":
        """The fused per-poll dispatch: build the lane validity mask from
        the cached feedback arrays (a camera counts only while active,
        reachable, and holding samples -- crashed-but-not-yet-failed
        cameras hold, exactly as the host path never consults their
        controller), hand last poll's drift residuals to the tick, and
        route fired lanes through recharacterize + ``retick``."""
        valid = np.zeros(fleet.n_lanes, bool)
        for cid in active:
            cam = self._cams.get(cid)
            if cam is None or cam.crashed:
                continue
            lane = fleet.lane_of[cid]
            valid[lane] = rec.lat_valid[lane]
        errs = dvalid = None
        if rec.drift_pending is not None:
            errs, dvalid = rec.drift_pending
            rec.drift_pending = None
        # an all-drained poll still ticks when drift is armed (the monitor
        # observes every poll, fused or not) but records no history row --
        # the unfused path never decided on empty polls either
        result = fleet.tick(rec.lat_lane, valid, errs, dvalid,
                            record=bool(active))
        if result.fired_cams:
            self._refresh_cameras(rec, result.fired_cams)
            if active:
                result = fleet.retick()
        return result

    def _drift_tick(self, rec: _Subscription,
                    frames: list[DeliveredFrame], *,
                    fused: bool = False) -> None:
        """One staleness-monitor tick: aggregate this poll's observed
        wire-size residuals per camera, flag drifted lanes, and
        re-characterize exactly those lanes.

        Two residual channels feed each lane, combined by max:

        * **wire size** -- ``|observed - predicted| / predicted`` per
          delivered frame, where predicted is the live table's clip-median
          wire size for the setting the frame shipped under.  A regime that
          compresses differently (or a fault-injected stale size axis)
          steps this signal.
        * **scene activity** -- the live stream's mean knob5 change
          fraction (observed on the RAW frames by ``fetch``, so it survives
          knob5 drops) against the table's calibration-clip ``activity``
          statistic.  More/faster movers over the same background barely
          move wire sizes but multiply this signal.

        A fired lane re-sweeps via ``CamBroker.recharacterize`` (log-tail
        clip, pseudo-GT scoring); the host controller swaps immediately and
        a fleet-backed subscription's ``FleetController.sync`` hot-swaps
        the lane at the next poll's decide -- identical one-poll-later
        semantics on both control paths, which is what keeps host and
        fleet traces byte-identical.  Both successful and unavailable
        re-sweeps surface as TABLE_REFRESH events.

        With ``fused`` (a live fleet), the monitor step itself rides in the
        next poll's fused dispatch: this method only aggregates the
        residuals into lane arrays (O(cameras fetched this poll), not
        O(N)); ``_fleet_tick`` consumes them at the next poll's start --
        the same poll position where the unfused path applied its
        ``pending_refresh`` queue, so fire counts, refresh timing and
        events are identical.
        """
        if rec.drift is None:
            return
        size_res: dict[str, list[float]] = {}
        for f in frames:
            if f.frame is None or f.knob_index < 0:
                continue
            cam = self._cams.get(f.camera_id)
            if cam is None or cam.controller is None:
                continue
            table = cam.controller.table
            if f.knob_index >= len(table.size_by_setting):
                continue
            size_res.setdefault(f.camera_id, []).append(
                relative_size_error(
                    float(table.size_by_setting[f.knob_index]),
                    float(f.wire_bytes)))
        samples: dict[str, float] = {}
        # only cameras fetched this poll can carry residuals: wire sizes
        # come from delivered frames and the activity accumulator fills
        # during ``fetch`` and drains every poll, so the sweep is bounded
        # by the batch, not the fleet
        for cid in {f.camera_id for f in frames}:
            cam = self._cams.get(cid)
            if cam is None or cam.crashed or cam.controller is None:
                continue
            channels: list[float] = []
            if cid in size_res:
                channels.append(float(np.mean(size_res[cid])))
            acts = cam.drain_activity()
            ref_act = getattr(cam.controller.table, "activity", None)
            if acts and ref_act is not None:
                channels.append(abs(float(np.mean(acts)) - ref_act)
                                / max(ref_act, DRIFT_ACTIVITY_FLOOR))
            if channels:
                samples[cid] = max(channels)
        if fused and rec.fleet is not None:
            if samples:
                n = len(rec.drift.cam_ids)
                errs = np.zeros(n, np.float32)
                valid = np.zeros(n, bool)
                for cid, v in samples.items():
                    lane = rec.fleet.lane_of[cid]
                    errs[lane] = v
                    valid[lane] = True
                rec.drift_pending = (errs, valid)
            return
        for cid in rec.drift.observe(samples):
            if cid not in rec.pending_refresh:
                rec.pending_refresh.append(cid)

    def _apply_pending_refreshes(self, rec: _Subscription) -> None:
        """Re-characterize the lanes the drift monitor fired last poll.

        Runs at the top of the poll, BEFORE any control decision: the host
        controller and (via ``FleetController.sync`` inside ``decide``) the
        fleet lane both trade on the fresh tables for this poll's fetches,
        and every batch already handed to the subscriber keeps referencing
        the table its decisions were made against."""
        if not rec.pending_refresh:
            return
        fired, rec.pending_refresh = rec.pending_refresh, []
        self._refresh_cameras(rec, fired)

    def _refresh_cameras(self, rec: _Subscription, fired) -> None:
        """Re-sweep the given lanes' tables from their own recent frames,
        emitting one TABLE_REFRESH event per lane either way.  Shared by
        the host queue (``_apply_pending_refreshes``) and the fused tick's
        fire-set (``_fleet_tick``)."""
        for cid in fired:
            cam = self._cams.get(cid)
            cur = rec.cameras.get(cid)
            at = cur.cursor if cur is not None else 0.0
            if cam is None or cam.crashed:
                rec.events.append(SessionEvent(
                    EventKind.TABLE_REFRESH, cid, rec.sub_id, at,
                    "drift: camera unreachable; stale tables kept"))
                continue
            try:
                refreshed = cam.recharacterize()
            except BrokerDown:
                rec.events.append(SessionEvent(
                    EventKind.TABLE_REFRESH, cid, rec.sub_id, at,
                    "drift: camera unreachable; stale tables kept"))
                continue
            rec.events.append(SessionEvent(
                EventKind.TABLE_REFRESH, cid, rec.sub_id, at,
                "drift: tables re-swept from live frames" if refreshed
                else "drift: re-sweep unavailable; stale tables kept"))

    def _fetch_into(self, rec: _Subscription, camera_id: str, budget: int,
                    out: list[DeliveredFrame], *,
                    decision: ControlDecision | None = None) -> None:
        """One on-demand fetch round for one camera of a subscription.
        ``decision`` carries the camera's lane of a fleet control tick; the
        host controller is then bypassed for this fetch."""
        cur = rec.cameras[camera_id]
        budget = min(budget, rec.credit_limit)
        if budget <= 0:
            return
        cam = self._cams.get(camera_id)
        if cam is None:
            cur.failed = True
            rec.invalidate_active()
            rec.events.append(SessionEvent(
                EventKind.RPC_TIMEOUT, camera_id, rec.sub_id, cur.cursor,
                "camera unregistered"))
            return
        feedback = None
        if decision is None:
            feedback = (float(np.percentile(cur.window, 95))
                        if cur.window else None)
        # credit ledger: the window is granted to the camera for the
        # duration of the fetch RPC and handed back when it returns.  A
        # crash mid-fetch leaves the credits held by the dead camera; they
        # come back at reattach_camera (or are written off at teardown),
        # never silently -- credit_report()'s leaked term must stay 0.
        cur.credits_held += budget
        rec.credits_granted += budget
        try:
            frames = cam.fetch(cur.cursor, cur.spec.t_stop,
                               latency_feedback=feedback,
                               controlled=rec.controlled,
                               max_frames=budget,
                               decision=decision,
                               budget_scale=rec.budget_scale)
        except BrokerDown as e:
            cur.failed = True
            rec.invalidate_active()
            rec.events.append(SessionEvent(
                EventKind.RPC_TIMEOUT, camera_id, rec.sub_id, cur.cursor,
                str(e)))
            return
        cur.credits_held -= budget
        rec.credits_returned += budget
        if not frames:
            cur.drained = True
            rec.invalidate_active()
            return
        replica = self.replicas[camera_id]
        infeasible_seen = False
        window_touched = False
        for f in frames:
            cur.cursor = max(cur.cursor, float(np.nextafter(f.timestamp,
                                                            np.inf)))
            lat = dataclasses.replace(
                f.latency,
                broker_processing=BROKER_PROC_COST,
                subscribe_api=SUBSCRIBE_API_COST)
            g = dataclasses.replace(f, latency=lat)
            if g.infeasible:
                infeasible_seen = True
            if g.frame is not None:
                replica.append(g.timestamp, g.frame)
                cur.window.append(g.latency.total)
                cur.window[:] = cur.window[-rec.feedback_window:]
                window_touched = True
            out.append(g)
        if window_touched and rec.lat_valid is not None \
                and rec.fleet is not None:
            # feedback windows only mutate here, so refreshing the lane's
            # p95 per fetch is value-identical to the per-poll recompute
            # the unfused path did -- and drops it from the poll hot loop
            lane = rec.fleet.lane_of[camera_id]
            rec.lat_lane[lane] = np.percentile(cur.window, 95)
            rec.lat_valid[lane] = True
        if infeasible_seen:
            rec.events.append(SessionEvent(
                EventKind.INFEASIBLE, camera_id, rec.sub_id,
                frames[-1].timestamp,
                "latency/accuracy bounds infeasible; serving best effort"))
        if cur.cursor > cur.spec.t_stop:
            cur.drained = True
            rec.invalidate_active()

    def update_subscription_qos(self, subscription_id: str, *,
                                latency: float | None = None,
                                accuracy: float | None = None,
                                recharacterize: bool = False) -> QosUpdate:
        """Renegotiate (latency, accuracy) bounds on a LIVE subscription.

        The per-camera ``LatencyController`` is retargeted in place (paper
        Fig. 9 SetTarget at runtime): no teardown, no resubscribe, cursors
        and feedback windows survive.  With ``recharacterize``, each
        camera's knob tables are first re-swept over its own recent frames
        (``CamBroker.recharacterize``) and hot-swapped into the live
        controller -- host and device tables alike -- so the renegotiated
        bounds bind against CURRENT scene/network statistics, not the
        startup calibration clip.  Cameras that are crashed fail the update
        individually (RPC_TIMEOUT event) without aborting the rest.
        """
        if self.crashed:
            raise RPCTimeout("EdgeBroker down")
        rec = self._subscriptions.get(subscription_id)
        if rec is None:
            return QosUpdate(latency or 0.0, accuracy or 0.0, Status.FAIL,
                             (), subscription_id, subscription_ids=())
        applied: list[str] = []
        recharacterized: list[str] = []
        per_camera: list[CameraQosResult] = []
        new_lat = new_acc = 0.0
        for cid, cur in rec.cameras.items():
            if cur.detached or cur.failed:
                continue
            new_lat = latency if latency is not None else cur.spec.latency
            new_acc = accuracy if accuracy is not None else cur.spec.accuracy
            cur.spec = dataclasses.replace(cur.spec, latency=new_lat,
                                           accuracy=new_acc)
            cam = self._cams.get(cid)
            if cam is None:
                continue
            try:
                did_rechar = bool(recharacterize and cam.recharacterize())
                if did_rechar:
                    recharacterized.append(cid)
                # retarget AFTER the table swap: the operating point
                # re-seeds into the freshly characterized size axis
                if cam.retarget(new_lat, new_acc):
                    applied.append(cid)
                    per_camera.append(CameraQosResult(
                        cid, Status.OK, recharacterized=did_rechar))
                else:
                    per_camera.append(CameraQosResult(
                        cid, Status.FAIL, recharacterized=did_rechar))
            except BrokerDown as e:
                cur.failed = True
                rec.invalidate_active()
                rec.events.append(SessionEvent(
                    EventKind.RPC_TIMEOUT, cid, rec.sub_id, cur.cursor,
                    str(e)))
                per_camera.append(CameraQosResult(cid, Status.FAIL))
        if rec.slo is not None or any(r.slo is not None
                                      for r in self._subscriptions.values()):
            # new bounds move the subscription's wire demand: re-divide
            with self._admission_lock:
                self._reallocate(at=max((c.cursor
                                         for c in rec.cameras.values()),
                                        default=0.0))
        return QosUpdate(new_lat, new_acc,
                         Status.OK if applied else Status.FAIL,
                         tuple(applied), subscription_id,
                         recharacterized=tuple(recharacterized),
                         per_camera=tuple(per_camera),
                         tenant=rec.tenant or "",
                         slo_class=rec.slo.name if rec.slo else "",
                         subscription_ids=(subscription_id,))

    def reattach_camera(self, subscription_id: str, camera_id: str) -> Status:
        """Re-admit a recovered camera into a live subscription.

        A camera that crashed mid-stream is marked failed and stops being
        polled; after the node reboots (``CamBroker.recover``) the scenario
        /operator re-attaches it here.  The cursor resumes exactly where it
        stopped -- frames published while the camera was down are still in
        its log and are delivered late rather than lost (at-most-once is
        preserved; nothing is re-fetched).  Credits held by a fetch that was
        in flight at crash time are returned here -- the crashed node can
        never hand them back itself, and leaving them on the cursor leaks
        the subscription's credit window a little more on every
        crash/recover cycle.  FAIL when the subscription or camera is
        unknown, or the camera is still crashed; OK (idempotent) when the
        camera was never failed.
        """
        if self.crashed:
            raise RPCTimeout("EdgeBroker down")
        rec = self._subscriptions.get(subscription_id)
        if rec is None:
            return Status.FAIL
        cur = rec.cameras.get(camera_id)
        cam = self._cams.get(camera_id)
        if cur is None or cam is None or cam.crashed:
            return Status.FAIL
        cur.failed = False
        if cur.credits_held:
            rec.credits_returned += cur.credits_held
            cur.credits_held = 0
        rec.invalidate_active()
        # the returning lane re-enters the wire-budget accounting: without
        # this, a subscription that went dark mid-degradation resumes at a
        # stale scale while other classes carry its share of the shortfall
        if self._slo_subs():
            with self._admission_lock:
                self._reallocate(at=cur.cursor)
        return Status.OK

    # -- federation support (herd camera migration) --------------------------------
    def export_camera(self, camera_id: str, *, at: float = 0.0
                      ) -> tuple[CamBroker, list, dict]:
        """Detach a camera and everything it owns here, for a herd
        migration.

        Returns ``(cam, replica_tail, cursors)``: the camera-node broker
        object itself (its ``HostLog``, live ``CharacterizationTable`` +
        device tables, and host PI controller all travel with it), the
        edge replica's frames (the target replays them into a fresh
        replica; its monotonic-timestamp rule dedupes any overlap), and the
        per-subscription ``_CamCursor`` records keyed by local sub id (the
        herd re-creates each as a part on the target and imports the cursor
        so polling resumes exactly where it stopped).

        Bookkeeping handled here, per the migration contract:

        * in-flight fetch credits are DRAINED -- returned to each
          subscription's ledger exactly like ``reattach_camera`` does for a
          recovered crash (the fetch RPC can never complete against the old
          route), so ``credit_report()`` stays conserved herd-wide;
        * fleet subscriptions export the camera's lane state back into the
          host controller (``FleetController.export_lane``) so the PI
          integral survives the hand-off; the source fleet's lane goes
          permanently invalid in place (the fused tick holds it, exactly
          like a crashed camera) -- no rebuild, no retrace;
        * the camera's entries in the shared frame cache are invalidated
          (the source must never serve a payload for a camera it no longer
          routes);
        * subscriptions left with zero cameras are closed (their ledgers
          fold into the broker totals) and the wire budget is reallocated.
        """
        if self.crashed:
            raise RPCTimeout("EdgeBroker down")
        cam = self._cams.get(camera_id)
        if cam is None:
            raise RPCTimeout(f"unknown camera {camera_id}")
        cursors: dict[str, _CamCursor] = {}
        emptied = []
        for sub_id, rec in self._subscriptions.items():
            cur = rec.cameras.get(camera_id)
            if cur is None:
                continue
            if cur.credits_held:
                rec.credits_returned += cur.credits_held
                cur.credits_held = 0
            if rec.fleet is not None and camera_id in rec.fleet.lane_of:
                rec.fleet.export_lane(camera_id)
            del rec.cameras[camera_id]
            rec.invalidate_active()
            cursors[sub_id] = cur
            if not rec.cameras:
                emptied.append(sub_id)
            key = (rec.application_id, camera_id)
            ids = self._sub_index.get(key)
            if ids is not None:
                if sub_id in ids:
                    ids.remove(sub_id)
                if not ids:
                    del self._sub_index[key]
        for sub_id in emptied:
            self.close_subscription(sub_id)
        replica = self.replicas.pop(camera_id, None)
        tail = replica.snapshot() if replica is not None else []
        self.frame_cache.invalidate(camera_id)
        self.unregister(camera_id)
        if not emptied and self._slo_subs():
            # emptied subs already reallocated via close_subscription
            with self._admission_lock:
                self._reallocate(at=at)
        return cam, tail, cursors

    def adopt_camera(self, cam: CamBroker, *, replica_tail=()) -> None:
        """Attach a migrated camera: register it (re-pointing its shared
        cache at THIS edge's) and replay the source replica tail into the
        fresh replica.  The log's ordering rule rejects any frame at or
        before the replica's last timestamp, so the at-most-one frame both
        brokers saw during the route flip lands exactly once."""
        self.register(cam)
        rep = self.replicas[cam.camera_id]
        for ts, frame in replica_tail:
            rep.append(ts, frame)

    def import_camera_cursor(self, subscription_id: str, camera_id: str,
                             state: _CamCursor) -> None:
        """Install an exported cursor on a freshly-created part
        subscription: polling resumes at the migrated cursor position (not
        the spec's t_start -- nothing is re-fetched), the feedback window
        carries over so the fleet lane's p95 seed matches the source, and
        the failed flag survives (a camera that crashed mid-migration still
        needs reattach_camera after recovery)."""
        rec = self._subscriptions.get(subscription_id)
        if rec is None:
            raise RPCTimeout(f"unknown subscription {subscription_id}")
        cur = rec.cameras.get(camera_id)
        if cur is None:
            raise RPCTimeout(f"camera {camera_id} not in {subscription_id}")
        cur.cursor = max(cur.cursor, state.cursor)
        cur.window[:] = list(state.window)
        cur.failed = state.failed
        cur.drained = state.drained
        rec.invalidate_active()

    def close_subscription(self, subscription_id: str) -> Status:
        """Explicit teardown: evicts the record and scrubs the legacy
        (application, camera) index so the registry stays O(live
        subscriptions).  Safe on unknown/already-closed ids (FAIL)."""
        if self.crashed:
            raise RPCTimeout("EdgeBroker down")
        rec = self._subscriptions.pop(subscription_id, None)
        if rec is None:
            return Status.FAIL
        # fold the subscription's credit ledger into the broker totals;
        # credits still held by (dead) cameras can never return now and are
        # written off as dropped rather than vanishing from the accounting
        held = sum(c.credits_held for c in rec.cameras.values())
        self._credit_totals["granted"] += rec.credits_granted
        self._credit_totals["returned"] += rec.credits_returned
        self._credit_totals["dropped"] += rec.credits_dropped + held
        for cid in rec.cameras:
            key = (rec.application_id, cid)
            ids = self._sub_index.get(key)
            if ids is not None:
                if subscription_id in ids:
                    ids.remove(subscription_id)
                if not ids:
                    del self._sub_index[key]
        if any(r.slo is not None for r in self._subscriptions.values()):
            # a leaving tenant frees wire budget: restore degraded lanes
            with self._admission_lock:
                self._reallocate(at=max((c.cursor
                                         for c in rec.cameras.values()),
                                        default=0.0))
        return Status.OK

    def subscription_fleet(self, subscription_id: str
                           ) -> FleetController | None:
        """The live fleet control plane of a fleet-backed subscription
        (None for host-path subscriptions) -- introspection for parity
        tests and the fleet-scaling benchmark."""
        rec = self._subscriptions.get(subscription_id)
        return rec.fleet if rec is not None else None

    def subscription_drift(self, subscription_id: str) -> DriftMonitor | None:
        """The live staleness monitor of an auto-recharacterizing
        subscription (None otherwise) -- introspection for the drift tests
        and the fig12 benchmark."""
        rec = self._subscriptions.get(subscription_id)
        return rec.drift if rec is not None else None

    def subscription_events(self, subscription_id: str) -> list[SessionEvent]:
        """Drain pending out-of-band events for a subscription.  The buffer
        is bounded; when undrained events were evicted since the last call,
        the first returned event is an ``EVENTS_DROPPED`` marker."""
        rec = self._subscriptions.get(subscription_id)
        if rec is None:
            return []
        return rec.events.drain()

    def session_subscription_ids(self, session_id: str) -> list[str]:
        """Live subscription ids of a session (``Session.update_qos`` fans
        a renegotiation out over these)."""
        sess = self._sessions.get(session_id)
        if sess is None:
            return []
        return [sid for sid in sess.sub_ids if sid in self._subscriptions]

    def session_events(self, session_id: str) -> list[SessionEvent]:
        """Drain pending events across all subscriptions of a session,
        plus session-level events (admission rejections happen before a
        subscription record exists, so they land on the session)."""
        sess = self._sessions.get(session_id)
        if sess is None:
            return []
        out: list[SessionEvent] = sess.events.drain()
        for sub_id in sess.sub_ids:
            out.extend(self.subscription_events(sub_id))
        return out

    def subscription_state(self, subscription_id: str) -> SubscriptionState:
        rec = self._subscriptions.get(subscription_id)
        if rec is None:
            return SubscriptionState.CLOSED
        cams = rec.cameras.values()
        if any(c.active for c in cams):
            return SubscriptionState.ACTIVE
        if any(c.failed for c in cams):
            return SubscriptionState.FAILED
        return SubscriptionState.DRAINED

    # -- v1 compat shim ------------------------------------------------------------
    def subscribe(self, spec: SubscribeSpec, *,
                  controlled: bool = True,
                  feedback_window: int = 8,
                  fetch_window: int = 2) -> Iterator[DeliveredFrame]:
        """Deprecated v1 streaming subscription.  Use the v2 session API
        (``open_session`` / ``create_subscription`` / ``poll_subscription``)
        or, for existing v1 callers, ``repro_torch.compat.subscribe_v1``
        which wraps this without a per-call warning."""
        warnings.warn(
            "EdgeBroker.subscribe (v1 iterator API) is deprecated; use the "
            "v2 session API or repro_torch.compat.subscribe_v1",
            DeprecationWarning, stacklevel=2)
        return self._subscribe_v1(spec, controlled=controlled,
                                  feedback_window=feedback_window,
                                  fetch_window=fetch_window)

    def _subscribe_v1(self, spec: SubscribeSpec, *,
                      controlled: bool = True,
                      feedback_window: int = 8,
                      fetch_window: int = 2) -> Iterator[DeliveredFrame]:
        """v1 streaming subscription (paper Fig. 7), as a shim over the v2
        session machinery.

        Yields frames as they become available in [t_start, t_stop].  Each
        poll is capped at ``fetch_window`` frames so the control loop samples
        the subscriber-observed p95 latency at its interval rather than
        bulk-draining the camera log -- numerically identical to the original
        single-camera loop.
        """
        if self.crashed:
            raise RPCTimeout("EdgeBroker down")

        def gen() -> Iterator[DeliveredFrame]:
            sid = self.open_session(spec.application_id)
            sub_id = self.create_subscription(
                sid, (spec,),
                options=SubscriptionOptions(controlled=controlled,
                                            feedback_window=feedback_window,
                                            credit_limit=fetch_window),
                retarget=False)
            try:
                while True:
                    batch = self.poll_subscription(sub_id,
                                                   max_frames=fetch_window)
                    if not batch:
                        break
                    yield from batch.frames
            finally:
                if not self.crashed:
                    self.close_session(sid)

        return gen()

    def unsubscribe(self, application_id: str, camera_id: str) -> Status:
        """v1 Unsubscribe: detach the camera from every live subscription of
        this application.  Idempotent and deterministic: a second call, or a
        call naming an unknown camera/application, returns ``Status.FAIL``
        without raising or corrupting registry state."""
        if self.crashed:
            raise RPCTimeout("EdgeBroker down")
        detached = False
        for sub_id in self._sub_index.get((application_id, camera_id), []):
            rec = self._subscriptions.get(sub_id)
            if rec is None:
                continue
            cur = rec.cameras.get(camera_id)
            if cur is not None and not cur.detached:
                cur.detached = True
                if cur.credits_held:     # detached cameras never reattach
                    rec.credits_dropped += cur.credits_held
                    cur.credits_held = 0
                rec.invalidate_active()
                detached = True
        return Status.OK if detached else Status.FAIL

    # -- fault tolerance --------------------------------------------------------------
    def crash(self) -> None:
        self.crashed = True

    def persist(self) -> None:
        if self.store is not None:
            for log in self.replicas.values():
                self.store.persist(log)

    def recover(self) -> None:
        if self.store is not None:
            for cid in list(self.replicas):
                restored = self.store.recover(cid)
                if restored is not None:
                    self.replicas[cid] = restored
        self.crashed = False


class MezSystem:
    """Convenience facade wiring cameras + brokers + controller (the thing
    benchmarks instantiate)."""

    def __init__(self, channel: WirelessChannel, *,
                 store: LogSegmentStore | None = None,
                 wire_budget: float | None = None,
                 device: "str | torch.device | None" = None):
        self.channel = channel
        self.device = resolve_device(device)
        self.edge = EdgeBroker(  # mezlint: disable=MZ08 -- MezSystem is this package's single-broker facade: the counterpart of the blessed site in repro.core.broker
            store=store, wire_budget=wire_budget, device=self.device)
        self.cams: dict[str, CamBroker] = {}

    def add_camera(self, camera_id: str, *, distance_m: float = 6.0,
                   fps: float = 5.0) -> CamBroker:
        cam = CamBroker(camera_id, self.channel, distance_m=distance_m,
                        fps=fps, store=self.edge.store, device=self.device)
        self.cams[camera_id] = cam
        self.edge.register(cam)
        return cam


class NatsLikeSystem:
    """The NATS baseline (paper Section 5.2): low-latency general pub-sub,
    NO latency control, NO storage layer, 1 MB message size limit."""

    MESSAGE_LIMIT = 1_000_000  # bytes

    def __init__(self, channel: WirelessChannel):
        self.channel = channel
        self._cams: dict[str, dict] = {}
        self.rejected_oversize = 0

    def add_camera(self, camera_id: str, *, distance_m: float = 6.0,
                   fps: float = 5.0) -> None:
        self._cams[camera_id] = {"distance": distance_m, "fps": fps}
        self.channel.activate(camera_id)

    def get_camera_info(self) -> list[str]:
        return sorted(self._cams)

    def deliver(self, camera_id: str, timestamp: float, frame: np.ndarray
                ) -> DeliveredFrame:
        """Publish + fan out one frame, unmodified."""
        info = self._cams[camera_id]
        nbytes = wire_size(frame)
        if self.channel.scaled_bytes(nbytes) > self.MESSAGE_LIMIT:
            # Paper: "Since NATS has a 1MB message size limit, DukeMTMC frames
            # cannot be sent/received using NATS."
            self.rejected_oversize += 1
            raise ValueError(
                f"NATS message size limit exceeded: {nbytes} > 1MB")
        net = self.channel.transfer(nbytes, fps=info["fps"],
                                    distance_m=info["distance"])
        lat = LatencyBreakdown(publish_api=PUBLISH_API_COST * 0.5,
                               network=net,
                               broker_processing=BROKER_PROC_COST * 0.4,
                               subscribe_api=SUBSCRIBE_API_COST * 0.5)
        return DeliveredFrame(camera_id, timestamp, frame, nbytes, lat, -1)
