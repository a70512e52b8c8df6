"""Offline characterization (paper Sections 2.3-2.4) -> controller tables.

The controller (Algorithm 1) consumes three artifacts, all built here:

  1. ``LatencyRegression``   latency ~= a * wire_size + b   (paper Fig. 5:
     "approximately linear variation with video frame size").
  2. size -> best achievable accuracy   (paper: Binary Search Tree keyed by
     image size).  Array adaptation: a sorted size array + prefix-max of
     accuracy, queried with searchsorted -- the same O(log n) point query,
     vectorizable, and usable in batched device code.
  3. accuracy -> knob setting           (paper: hash table).  Here: the argmax
     index carried alongside the prefix-max, so lookup 2 is O(1).

``characterize()`` sweeps the knob grid over a calibration clip from a
``SyntheticCamera``, measuring wire sizes and normalized F1 (blob detector
vs. ground truth), mirroring the paper's offline measurement campaign
("assumed to be available from prior characterization").  Settings with
normalized F1 < min_accuracy are excluded, as the paper excludes combos
under 90%.

Two engines share the semantics:

``engine="batched"`` (default)  the device-resident grid sweep in
    ``core.grid_engine``: transforms + detector scoring batched over the
    settings dimension, wire sizes from the calibrated byte-delta proxy
    (zlib runs once per transform combo instead of once per setting-frame).
    Minutes -> seconds: cheap enough to re-run on live QoS renegotiation.
    Covers knob4 (``include_artifact=True``) device-side; only non-BGR or
    odd-geometry cameras need the reference engine.

``engine="reference"``  the seed per-frame NumPy path, kept verbatim as the
    oracle (exact zlib sizes, host detector).  Also the fallback for
    non-BGR or odd-geometry cameras, which the device grid does not cover.

``table_from_grid`` scores an already-run ``GridCharacterization`` into a
table -- the shared back half of the batched engine, also driven by
``grid_engine.refresh_tables`` for online re-characterization (where the
full-quality detections stand in for ground truth).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core import detector as det
from repro_torch.core import knobs as K
from repro_torch.device import resolve_device

if TYPE_CHECKING:
    from repro_torch.core.grid_engine import GridCharacterization, WireSizeProxy

__all__ = ["LatencyRegression", "CharacterizationTable", "characterize",
           "table_from_grid", "fit_latency_regression"]


@dataclasses.dataclass(frozen=True)
class LatencyRegression:
    """latency_seconds = slope * wire_bytes + intercept."""
    slope: float
    intercept: float

    def predict(self, wire_bytes: float) -> float:
        return self.slope * wire_bytes + self.intercept

    def invert(self, latency_s: float) -> float:
        """The paper's ``RegressionModel(latencyTarget)`` -> nominal size."""
        return max(0.0, (latency_s - self.intercept) / max(self.slope, 1e-12))


def fit_latency_regression(sizes: np.ndarray, latencies: np.ndarray
                           ) -> LatencyRegression:
    sizes = np.asarray(sizes, np.float64)
    lats = np.asarray(latencies, np.float64)
    a, b = np.polyfit(sizes, lats, 1)
    return LatencyRegression(float(a), float(b))


@dataclasses.dataclass
class CharacterizationTable:
    """The two lookup tables of Algorithm 1, in sorted-array form.

    sizes_sorted[i]   : wire size of the i-th smallest characterized setting
    best_acc[i]       : best accuracy achievable with wire size <= sizes_sorted[i]
    best_idx[i]       : index into ``settings`` achieving best_acc[i]
    settings          : the characterized knob settings (knob4 excluded by default)
    acc_by_setting    : accuracy of each setting
    size_by_setting   : median wire size of each setting
    proxy             : the batched engine's calibrated wire-size proxy
                        (None for reference-engine tables) -- lets
                        ``CamBroker.fetch`` pre-screen candidate settings
                        against the controller's size budget without
                        paying deflate per candidate
    min_accuracy      : the accuracy floor this table was filtered at --
                        online re-characterization re-applies the SAME
                        floor so the trade space doesn't silently shrink
                        or grow across a refresh
    source            : provenance tag ("offline" for a calibration-time
                        sweep, "online-refresh" for tables re-swept live
                        by ``grid_engine.refresh_tables``, "stale-injected"
                        for fault-injected tables) -- lets the drift tests
                        and the fig12 benchmark assert WHICH tables a
                        controller is actually trading on
    activity          : mean changed-pixel fraction between consecutive
                        calibration-clip frames (knob5's dissimilarity
                        metric) -- the scene-dynamics statistic these
                        measurements were taken under.  The drift monitor
                        compares the LIVE stream's change fractions
                        against it: a regime shift that barely moves wire
                        sizes (e.g. more movers over the same background)
                        still multiplies scene activity.  None for
                        synthetic / pre-drift tables (channel disabled)
    residual_spread   : q95 of the calibration clip's own per-frame wire-
                        size residuals (|frame - setting median| / median,
                        the drift monitor's residual unit) across the kept
                        settings -- how noisy this scene/codec regime is
                        even when NOTHING has drifted.  The drift monitor's
                        hysteresis thresholds are learned from it
                        (``drift.learned_thresholds``); None (synthetic /
                        legacy tables) falls back to the hand-set constants
    """
    settings: tuple[K.KnobSetting, ...]
    sizes_sorted: np.ndarray
    best_acc: np.ndarray
    best_idx: np.ndarray
    acc_by_setting: np.ndarray
    size_by_setting: np.ndarray
    proxy: "WireSizeProxy | None" = None
    min_accuracy: float = 0.90
    source: str = "offline"
    activity: float | None = None
    residual_spread: float | None = None

    @property
    def includes_artifact(self) -> bool:
        """Whether knob4 settings survived into this table.  Online
        re-characterization keys its sweep breadth on this: a live table
        trading on knob4 must not lose that axis across a refresh (a table
        that kept none re-sweeps without knob4, the cheaper default)."""
        return any(s.artifact > 0 for s in self.settings)

    def query_size(self, wire_bytes: float) -> tuple[float, int]:
        """size -> (best achievable accuracy, knob-setting index).

        Paper step 2: BST search keyed by image size.  Returns the best
        accuracy among settings whose size fits within ``wire_bytes``.
        """
        pos = int(np.searchsorted(self.sizes_sorted, wire_bytes, side="right")) - 1
        if pos < 0:
            return 0.0, -1
        return float(self.best_acc[pos]), int(self.best_idx[pos])

    def setting_for(self, idx: int) -> K.KnobSetting:
        return self.settings[idx]

    def step_down(self, idx: int, accuracy_floor: float, *,
                  diff: int | None = None) -> int:
        """The next-smaller-size characterized setting that still clears
        ``accuracy_floor`` -- the candidate walk of ``CamBroker.fetch``'s
        wire-size pre-screen.  ``diff`` pins the knob5 axis: the pre-screen
        trades transform fidelity for bytes, it must NOT change the drop
        semantics the controller decided on mid-walk.  Returns -1 when no
        smaller setting qualifies."""
        size = self.size_by_setting[idx]
        best = -1
        best_size = -1.0
        for j, (s, a) in enumerate(zip(self.size_by_setting,
                                       self.acc_by_setting)):
            if diff is not None and self.settings[j].diff != diff:
                continue
            if s < size and a >= accuracy_floor and s > best_size:
                best, best_size = j, float(s)
        return best

    # -- array views for the device tables ---------------------------------------
    def as_arrays(self) -> dict[str, np.ndarray]:
        return {
            "sizes_sorted": self.sizes_sorted.astype(np.float32),
            "best_acc": self.best_acc.astype(np.float32),
            "best_idx": self.best_idx.astype(np.int32),
        }


def _build_table(settings, sizes: np.ndarray, accs: np.ndarray,
                 min_accuracy: float,
                 proxy=None, activity: float | None = None,
                 residuals: list | None = None
                 ) -> CharacterizationTable:
    """keep/sort/prefix-max assembly, shared by both engines.

    ``residuals`` (optional, aligned with ``settings``) holds each
    setting's per-frame relative wire-size residuals against its own clip
    median; the q95 over the KEPT settings becomes ``residual_spread`` --
    the monitor only ever observes settings the controller can choose.
    """
    keep = (accs >= min_accuracy) & (sizes > 0)
    settings_kept = tuple(s for s, k in zip(settings, keep) if k)
    sizes_k = sizes[keep]
    accs_k = accs[keep]

    order = np.argsort(sizes_k, kind="stable")
    sizes_sorted = sizes_k[order]
    accs_sorted = accs_k[order]
    idx_sorted = np.arange(len(settings_kept))[order]

    # prefix max of accuracy + the setting achieving it
    best_acc = np.empty_like(accs_sorted)
    best_idx = np.empty(len(accs_sorted), np.int64)
    run_best, run_idx = -1.0, -1
    for i, (a, j) in enumerate(zip(accs_sorted, idx_sorted)):
        if a > run_best:
            run_best, run_idx = a, j
        best_acc[i] = run_best
        best_idx[i] = run_idx

    spread = None
    if residuals is not None:
        pool = [r for r, k in zip(residuals, keep)
                if k and r is not None and len(r)]
        if pool:
            spread = float(np.quantile(np.concatenate(pool), 0.95))

    return CharacterizationTable(
        settings=settings_kept,
        sizes_sorted=sizes_sorted,
        best_acc=best_acc,
        best_idx=best_idx,
        acc_by_setting=accs_k,
        size_by_setting=sizes_k,
        proxy=proxy,
        min_accuracy=min_accuracy,
        activity=activity,
        residual_spread=spread,
    )


def characterize(camera_factory, *, clip_len: int = 24,
                 min_accuracy: float = 0.90,
                 include_artifact: bool = False,
                 detector_thresh: float = 28.0,
                 engine: str = "auto",
                 device: "str | torch.device | None" = None
                 ) -> CharacterizationTable:
    """Sweep the knob grid on a calibration clip; build the tables.

    ``camera_factory()`` must return a fresh, identically-seeded
    ``SyntheticCamera`` so every knob setting sees the same clip.

    ``engine`` selects the sweep implementation: ``"batched"`` (the
    device-resident grid engine, knob4 included when asked), ``"reference"``
    (the per-frame NumPy oracle), or ``"auto"`` (batched whenever the camera
    geometry supports it -- non-BGR and odd-geometry cameras fall back to
    reference).  ``engine="batched"`` raises ``ValueError`` on unsupported
    geometry instead of silently degrading.

    ``device`` (default ``"cuda"``) is where the batched engine runs;
    ``device="cpu"`` runs it on the CPU.
    """
    dev = resolve_device(device)
    cam = camera_factory()
    bg = cam.background
    clip = [cam.next_frame() for _ in range(clip_len)]

    batched_ok = (bg.ndim == 3 and bg.shape[2] == 3
                  and bg.shape[0] % 2 == 0 and bg.shape[1] % 2 == 0)
    if engine == "auto":
        engine = "batched" if batched_ok else "reference"
    if engine == "batched":
        if not batched_ok:
            raise ValueError(
                f"engine='batched' needs an even-dimension 3-channel "
                f"background (4:2:0-subsample-able planes); got shape "
                f"{bg.shape}.  Use engine='reference' for odd geometries, "
                f"or engine='auto' to fall back automatically.")
        from repro_torch.core import grid_engine
        grid = grid_engine.run_grid(bg, [f for _, f, _ in clip],
                                    detector_thresh=detector_thresh,
                                    include_artifact=include_artifact,
                                    device=dev)
        return table_from_grid(grid, [gt for _, _, gt in clip],
                               min_accuracy=min_accuracy,
                               include_artifact=include_artifact)
    elif engine == "reference":
        settings, sizes, accs, residuals = _sweep_reference(
            bg, clip, include_artifact=include_artifact,
            detector_thresh=detector_thresh)
    else:
        raise ValueError(f"unknown characterization engine {engine!r}")
    fracs = [K.change_fraction(clip[i][1], clip[i - 1][1])
             for i in range(1, clip_len)]
    activity = float(np.mean([f for f in fracs if f is not None])) \
        if fracs else None
    return _build_table(settings, sizes, accs, min_accuracy,
                        activity=activity, residuals=residuals)


# =============================================================================
# Batched engine (device grid sweep + wire-size proxy)
# =============================================================================


def table_from_grid(grid: "GridCharacterization", gts: list[np.ndarray], *,
                    min_accuracy: float = 0.90,
                    include_artifact: bool = False) -> CharacterizationTable:
    """Score a batched grid sweep into a ``CharacterizationTable``.

    ``gts`` is one ground-truth box array per clip frame.  Online
    re-characterization (``grid_engine.refresh_tables``) passes the
    full-quality combo's own detections here, making accuracies normalized
    F1 against the unmodified stream -- the controller's actual trade
    currency -- without needing labels at runtime.
    """
    clip_len = len(gts)
    if include_artifact and not grid.include_artifact:
        raise ValueError("grid was run without include_artifact; re-run "
                         "run_grid(include_artifact=True)")
    settings = K.enumerate_settings(include_artifact=include_artifact)

    # per-frame match counts per transform combo, computed once and summed
    # per setting according to its drop pattern (knob5 never changes
    # surviving pixels, so detections are shared across diff thresholds)
    counts: dict[tuple[int, int, int, int], np.ndarray] = {}
    for combo, boxes in grid.dets.items():
        counts[combo] = np.asarray(
            [det.match_f1(gts[fi], boxes[fi]) for fi in range(clip_len)],
            np.int64)
    gt_sizes = np.asarray([len(gt) for gt in gts], np.int64)
    base = counts[(0, 0, 0, 0)].sum(axis=0)
    base_f1 = det.f1_from_counts(*base)

    drop_patterns = {di: grid.drop_pattern(thresh)
                     for di, thresh in enumerate(K.DIFF_THRESHOLDS)}

    sizes = np.zeros(len(settings))
    accs = np.zeros(len(settings))
    residuals: list = [None] * len(settings)
    for si, s in enumerate(settings):
        combo = (s.resolution, s.colorspace, s.blur, s.artifact)
        drops = drop_patterns[s.diff]
        kept = ~drops
        c = counts[combo][kept].sum(axis=0)
        # dropped frames: the application never saw them -> all GT becomes FN
        tp, fp, fn = int(c[0]), int(c[1]), int(c[2] + gt_sizes[drops].sum())
        f1 = det.f1_from_counts(tp, fp, fn)
        accs[si] = f1 / base_f1 if base_f1 > 0 else 0.0
        kept_sizes = grid.sizes[combo][kept[:clip_len]]
        sizes[si] = float(np.median(kept_sizes)) if kept_sizes.size else 0.0
        if kept_sizes.size:
            # per-frame residuals in the drift monitor's own unit
            # (drift.relative_size_error: denominator floored at 1 byte)
            p = max(sizes[si], 1.0)
            residuals[si] = np.abs(kept_sizes - p) / p
    # scene-activity statistic: mean consecutive-frame change fraction of
    # the calibration clip (the grid's knob5 matrix holds exactly these
    # counts) -- the drift monitor's reference point for this table
    activity = None
    if clip_len > 1:
        consec = [grid.change_fraction(i, i - 1) for i in range(1, clip_len)]
        activity = float(np.mean(consec))
    return _build_table(settings, sizes, accs, min_accuracy,
                        proxy=grid.proxy, activity=activity,
                        residuals=residuals)


# =============================================================================
# Reference engine (the seed per-frame NumPy path, kept as the oracle)
# =============================================================================


def _sweep_reference(bg, clip, *, include_artifact: bool,
                     detector_thresh: float):
    """Per-frame sweep with exact zlib wire sizes and the host detector.

    Fast path: knob5 (frame differencing) only *drops* frames -- it never
    changes surviving pixels -- so per-frame detections are computed once per
    (resolution, colorspace, blur[, artifact]) combo and reused across all
    diff thresholds; per-threshold drop patterns are computed once on the raw
    stream.  This turns an O(|grid| * clip) detector sweep into
    O(|grid|/n_diff * clip), matching how the paper's own campaign would be
    run (differencing is a transport decision, not an image transform).
    """
    clip_len = len(clip)
    h, w = bg.shape[:2]
    baseline = []
    for _, frame, gt in clip:
        boxes = det.detect(frame, bg, thresh=detector_thresh, scale_to=(h, w))
        baseline.append((gt, boxes))

    settings = K.enumerate_settings(include_artifact=include_artifact)

    # -- drop patterns per diff threshold (depends only on the raw stream) ----
    drop_patterns: dict[int, np.ndarray] = {}
    for di, thresh in enumerate(K.DIFF_THRESHOLDS):
        drops = np.zeros(clip_len, bool)
        last_sent = None
        for fi, (_, frame, _) in enumerate(clip):
            if K.frame_difference(frame, last_sent, thresh):
                drops[fi] = True
            else:
                last_sent = frame
        drop_patterns[di] = drops

    # -- per-transform detections (diff dimension factored out) ---------------
    cache: dict[tuple[int, int, int, int], tuple[list[np.ndarray], np.ndarray]] = {}
    bg_memo = K.TransformMemo(bg)

    def transform_results(s: K.KnobSetting):
        key = (s.resolution, s.colorspace, s.blur, s.artifact)
        if key in cache:
            return cache[key]
        tkey = K.KnobSetting(s.resolution, s.colorspace, s.blur, s.artifact, 0)
        bg_t = bg_memo.get(tkey)             # subscriber's degraded background
        dets: list[np.ndarray] = []
        wires = np.zeros(clip_len)
        for fi, (_, frame, _) in enumerate(clip):
            r = K.apply_knobs(frame, dataclasses.replace(tkey, diff=0),
                              background=bg, last_sent=None)
            assert r.frame is not None
            wires[fi] = r.wire_bytes
            dets.append(det.detect(r.frame, bg_t, thresh=detector_thresh,
                                   scale_to=(h, w)))
        cache[key] = (dets, wires)
        return cache[key]

    sizes = np.zeros(len(settings))
    accs = np.zeros(len(settings))
    residuals: list = [None] * len(settings)
    for si, setting in enumerate(settings):
        dets, wires = transform_results(setting)
        drops = drop_patterns[setting.diff]
        results = []
        kept_wires = []
        for fi, (_, _, gt) in enumerate(clip):
            if drops[fi]:
                results.append((gt, np.zeros((0, 4), np.float32)))
            else:
                results.append((gt, dets[fi]))
                kept_wires.append(wires[fi])
        sizes[si] = float(np.median(kept_wires)) if kept_wires else 0.0
        if kept_wires:
            p = max(sizes[si], 1.0)
            residuals[si] = np.abs(np.asarray(kept_wires) - p) / p
        accs[si] = det.normalized_f1(results, baseline)
    return settings, sizes, accs, residuals
