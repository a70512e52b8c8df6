"""Drift detection for characterization tables (auto re-characterization).

Mez's tables map frame-quality knobs to (wire size, accuracy) for the scene
regime they were characterized on (paper Sections 2.3-2.4).  When the scene
shifts -- more movers, busier texture, a workload change -- the table's
per-setting wire sizes stop predicting what the camera actually ships, and
its accuracy claims silently rot with them.

A **staleness monitor** tracks, per camera, the windowed relative error
between the table-predicted wire size of the setting each frame shipped
under and the observed exact deflate bytes.  A lane whose windowed score
crosses the ``hi`` threshold while armed FIRES; the broker answers by running
``CamBroker.recharacterize`` on that camera's own recent frames and
hot-swapping the fresh tables into the live controller (host and fleet lane
alike, PI integral carried -- the ``swap_table`` contract).

Hysteresis makes the trigger well-behaved: a fired lane disarms and clears
its window (every buffered sample was measured against the now-replaced
table), and only re-arms once a full ``min_samples`` of post-refresh
observations score below the ``lo`` threshold.

The monitor core is a batched tensor function over the camera axis: N
cameras cost one pass of tensor ops per poll, and thresholds and window
contents are tensor inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.partition import LaneChunks

__all__ = ["DriftConfig", "DriftParams", "DriftState", "drift_init",
           "drift_update", "relative_size_error", "learned_thresholds",
           "DriftMonitor"]


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Host-side knobs of the staleness monitor.

    ``window`` sizes the ring buffer; the thresholds are tensor inputs.
    Defaults are sized for the deflate spread of a stationary synthetic
    scene (per-frame wire bytes sit within ~10-20% of the characterization
    clip median): a sustained 35% mean mismatch is a regime change, not
    noise.
    """
    window: int = 8          # ring-buffer samples per lane (one per poll)
    hi: float = 0.35         # fire when windowed mean rel-err exceeds this
    lo: float = 0.15         # re-arm only once the mean drops below this
    min_samples: int = 4     # samples required before fire/re-arm decisions


@dataclasses.dataclass
class DriftParams:
    """The monitor thresholds, one entry per lane."""
    hi: torch.Tensor            # f32[N]
    lo: torch.Tensor            # f32[N]
    min_samples: torch.Tensor   # i32[N]

    @classmethod
    def from_config(cls, config: DriftConfig, n: int | None = None, *,
                    device: "str | torch.device | None" = None
                    ) -> "DriftParams":
        """``n`` identical lanes on ``device`` (default ``"cuda"``), or
        scalar thresholds for one unstacked lane (``n=None``)."""
        device = resolve_device(device)
        shape = () if n is None else (n,)
        return cls(torch.full(shape, config.hi, dtype=torch.float32,
                              device=device),
                   torch.full(shape, config.lo, dtype=torch.float32,
                              device=device),
                   torch.full(shape, config.min_samples, dtype=torch.int32,
                              device=device))


@dataclasses.dataclass
class DriftState:
    """Per-lane monitor state along a leading camera axis (none for one
    unstacked lane: ``errs [window]`` and scalar counters)."""
    errs: torch.Tensor      # f32[N, window] ring of |relative error| samples
    pos: torch.Tensor       # i32[N] next ring slot
    count: torch.Tensor     # i32[N] live samples (saturates at window)
    armed: torch.Tensor     # bool[N] hysteresis: True = may fire
    fires: torch.Tensor     # i32[N] cumulative fire count (telemetry)


def drift_init(n: int | None, window: int, *,
               device: "str | torch.device | None" = None) -> DriftState:
    """Fresh, armed state for ``n`` lanes on ``device`` (default
    ``"cuda"``); ``n=None``: one unstacked lane."""
    device = resolve_device(device)
    shape = () if n is None else (n,)
    return DriftState(
        errs=torch.zeros(shape + (window,), dtype=torch.float32,
                         device=device),
        pos=torch.zeros(shape, dtype=torch.int32, device=device),
        count=torch.zeros(shape, dtype=torch.int32, device=device),
        armed=torch.ones(shape, dtype=torch.bool, device=device),
        fires=torch.zeros(shape, dtype=torch.int32, device=device),
    )


def drift_update(state: DriftState, errs, valid, params: DriftParams
                 ) -> tuple[DriftState, torch.Tensor, torch.Tensor]:
    """One monitor tick for a whole fleet: push -> score -> hysteresis
    decision, lane by lane.  Returns (new_state, fired[N] bool, score[N]
    f32).  A state of one unstacked lane (``drift_init(None, window)``)
    takes scalar ``errs``/``valid``/params and returns scalars.

    Invalid observations (no frames shipped this poll) leave the lane
    untouched except that the decision is still evaluated -- a lane cannot
    fire while empty because ``count`` gates on ``min_samples``.
    """
    dev = state.errs.device
    err = torch.as_tensor(errs, device=dev).to(torch.float32).abs()
    valid = torch.as_tensor(valid, device=dev).to(torch.bool)
    if state.pos.dim() == 0:
        one = DriftState(*(x[None] for x in dataclasses.astuple(state)))
        lane = DriftParams(*(x[None] for x in (params.hi, params.lo,
                                               params.min_samples)))
        new, fired, score = drift_update(one, err[None], valid[None], lane)
        return (DriftState(*(x[0] for x in dataclasses.astuple(new))),
                fired[0], score[0])
    n, window = state.errs.shape
    lane = torch.arange(n, device=err.device)
    pushed = state.errs.clone()
    pushed[lane, state.pos.long()] = err
    ring = torch.where(valid[:, None], pushed, state.errs)
    pos = torch.where(valid, (state.pos + 1) % window, state.pos)
    count = torch.where(valid, torch.clamp(state.count + 1, max=window),
                        state.count)
    live = torch.arange(window, device=err.device)[None, :] < count[:, None]
    kept = torch.where(live, ring, 0.0)
    total = kept[:, 0]
    for i in range(1, window):            # the window sum, in slot order
        total = total + kept[:, i]
    score = total / torch.clamp(count, min=1).to(torch.float32)
    ready = count >= params.min_samples
    fired = state.armed & ready & (score > params.hi)
    rearm = ~state.armed & ready & (score < params.lo)
    armed = torch.where(fired, False, torch.where(rearm, True, state.armed))
    # a fired lane's window is cleared: every buffered residual was measured
    # against the table the fire is about to replace
    ring = torch.where(fired[:, None], 0.0, ring)
    pos = torch.where(fired, 0, pos).to(torch.int32)
    count = torch.where(fired, 0, count).to(torch.int32)
    new_state = DriftState(errs=ring, pos=pos, count=count, armed=armed,
                           fires=state.fires + fired.to(torch.int32))
    return new_state, fired, score


# The learned-threshold law: fire when the windowed residual exceeds this
# multiple of the calibration clip's own q95 residual spread.  The hand-set
# DriftConfig constants stay as the FLOOR (and the fallback when a table
# predates the spread statistic), so a quiet clip keeps the proven 0.35/0.15
# hysteresis while a noisy-but-stationary scene raises its own bar instead
# of false-firing.
SPREAD_MULTIPLE = 3.0
HI_CEILING = 0.90


def learned_thresholds(spread: float | None,
                       base: DriftConfig | None = None
                       ) -> tuple[float, float]:
    """Quantile-learned (hi, lo) hysteresis thresholds for one camera.

    ``spread`` is ``CharacterizationTable.residual_spread`` -- the q95 of
    per-frame ``|wire - median| / median`` over the calibration clip, i.e.
    the residual the monitor would see on a PERFECTLY stationary scene.
    ``hi`` is ``SPREAD_MULTIPLE``x that, floored at the base constants and
    ceilinged below 1 (a regime shift lands near 1.0); ``lo`` keeps the
    base config's hysteresis ratio.  ``None``/degenerate spread falls back
    to the constants unchanged.
    """
    base = base or DriftConfig()
    if spread is None or not np.isfinite(spread) or spread <= 0.0:
        return float(base.hi), float(base.lo)
    hi = float(np.clip(SPREAD_MULTIPLE * float(spread), base.hi, HI_CEILING))
    lo = hi * (base.lo / base.hi)
    return hi, lo


def relative_size_error(predicted: float, observed: float) -> float:
    """|observed - predicted| / predicted -- the monitor's residual unit.

    ``predicted`` is the live table's median wire size for the setting the
    frame shipped under; ``observed`` is the exact deflate byte count that
    crossed the channel.  Guarded so a degenerate table row (size 0) never
    poisons the window with inf."""
    p = max(float(predicted), 1.0)
    return abs(float(observed) - p) / p


class DriftMonitor:
    """Host orchestrator: N per-camera staleness lanes as ONE batched
    ``drift_update`` per poll, on ``device`` (default ``"cuda"``).

    The broker feeds one aggregated observation per camera per poll (the
    mean relative size error of the frames that camera shipped); lanes with
    no shipped frames pass ``valid=False`` and hold.  ``observe`` returns
    the camera ids whose lanes fired this tick -- the exact set the caller
    re-characterizes.
    """

    def __init__(self, cam_ids, config: DriftConfig | None = None, *,
                 spreads: "dict[str, float | None] | None" = None,
                 device: "str | torch.device | None" = None):
        self.cam_ids = list(cam_ids)
        if not self.cam_ids:
            raise ValueError("DriftMonitor needs at least one camera")
        self.device = resolve_device(device)
        self.config = config or DriftConfig()
        n = len(self.cam_ids)
        self._lane = {cid: i for i, cid in enumerate(self.cam_ids)}
        self.state = drift_init(n, self.config.window, device=self.device)
        if config is None and spreads:
            # learned per-lane thresholds (quantile of the calibration
            # clip's own residual spread)
            pairs = [learned_thresholds(spreads.get(cid), self.config)
                     for cid in self.cam_ids]
            self.thresholds = {cid: pairs[i]
                               for i, cid in enumerate(self.cam_ids)}
            self.params = DriftParams(
                hi=torch.tensor([p[0] for p in pairs], dtype=torch.float32,
                                device=self.device),
                lo=torch.tensor([p[1] for p in pairs], dtype=torch.float32,
                                device=self.device),
                min_samples=torch.full((n,), self.config.min_samples,
                                       dtype=torch.int32, device=self.device))
        else:
            self.thresholds = {cid: (self.config.hi, self.config.lo)
                               for cid in self.cam_ids}
            self.params = DriftParams.from_config(self.config, n,
                                                  device=self.device)
        self.last_scores: dict[str, float] = {}
        # the fleet whose fused tick carries these lanes (attach_drift), and
        # the (lanes, window) layouts this monitor's own update has run on
        self._fused = None
        self._layouts: set[tuple[int, ...]] = set()

    def __len__(self) -> int:
        return len(self.cam_ids)

    def bind_fused(self, fleet) -> None:
        """Mark this monitor as fused into ``fleet``'s tick
        (``FleetController.attach_drift``): its lanes advance there, so
        ``cache_size`` reports the fused tick's count."""
        self._fused = fleet

    def cache_size(self) -> int:
        """How many state layouts (lanes x window) the monitor's update
        has run on (1 = every tick kept the shapes); a fused monitor
        reports the fused fleet tick's count."""
        if self._fused is not None:
            return self._fused.cache_size()
        return len(self._layouts)

    def absorb_fused(self, state, fired, scores) -> list[str]:
        """Adopt post-tick drift lanes computed inside a fused fleet tick.

        ``state`` may carry mesh-padding lanes beyond ``len(cam_ids)``
        (sliced off here: a ``LaneChunks`` of a meshed fleet keeps its
        chunks on their devices and marks only the first lanes real);
        ``fired``/``scores`` are host arrays from the tick's aux.  Returns
        fired camera ids in lane order, exactly like ``observe``."""
        n = len(self.cam_ids)
        fired = np.asarray(fired)[:n]
        scores = np.asarray(scores)[:n]
        if isinstance(state, LaneChunks):
            state = state.head(n)
        elif state.pos.shape[0] != n:
            state = DriftState(*(x[:n] for x in dataclasses.astuple(state)))
        self.state = state
        self.last_scores = {cid: float(scores[i])
                            for i, cid in enumerate(self.cam_ids)}
        return [cid for i, cid in enumerate(self.cam_ids) if fired[i]]

    def observe(self, samples: "dict[str, float]") -> list[str]:
        """One monitor tick.  ``samples`` maps camera_id -> mean relative
        size error of the frames that camera shipped this poll (cameras
        absent from the mapping hold their window).  Returns the camera ids
        that fired, in lane order."""
        n = len(self.cam_ids)
        errs = np.zeros(n, np.float32)
        valid = np.zeros(n, bool)
        for cid, err in samples.items():
            i = self._lane.get(cid)
            if i is None:
                continue
            errs[i] = err
            valid[i] = True
        self.state = self._whole_state()
        self._layouts.add(tuple(self.state.errs.shape))
        self.state, fired, scores = drift_update(
            self.state, torch.as_tensor(errs).to(self.device),
            torch.as_tensor(valid).to(self.device), self.params)
        fired_np = fired.cpu().numpy()
        scores_np = scores.cpu().numpy()
        self.last_scores = {cid: float(scores_np[i])
                            for i, cid in enumerate(self.cam_ids)}
        return [cid for i, cid in enumerate(self.cam_ids) if fired_np[i]]

    def _whole_state(self) -> DriftState:
        """The state as one record on ``device`` (a meshed fleet's tick
        leaves it in chunks)."""
        if isinstance(self.state, LaneChunks):
            return self.state.gather(self.device)
        return self.state

    def fire_counts(self) -> dict[str, int]:
        fires = self._whole_state().fires.cpu().numpy()
        return {cid: int(fires[i]) for i, cid in enumerate(self.cam_ids)}
