"""Batched device-side characterization engine (the knob grid in one sweep).

Characterization evaluates every knob setting over a calibration clip.  This
engine runs the grid as device-resident batches so characterization is cheap
enough to re-run live on QoS renegotiation (CANS-style online
self-configuration):

  1. **Transform stage** -- the knob pipeline (knob4 -> colorspace -> resize
     -> blur) for every setting of one (resolution, colorspace) group runs
     in one ``kernels.frame_knobs.frame_knob_grid`` call over the whole
     clip: the hand-written CUDA kernel on the card, its plain PyTorch
     version on the CPU.
  2. **Wire-size proxy** -- per-payload byte-delta statistics (computed in
     the same pass) are calibrated against zlib level-1 on one frame per
     combo, then predict the wire size of every (setting, frame).  The
     stream path (``CamBroker.fetch`` -> ``knobs.wire_size``) keeps exact
     zlib for the frames actually sent.
  3. **Detector scoring** -- the background diff runs batched over the
     settings dimension on the device; thresholding, dilation and component
     labeling run vectorized over the ``[settings, frames]`` batch (the
     pointer-jumping min-propagation labeler ``_label_group`` on the card,
     scipy's C labeling on the CPU).  Box extraction is segment-vectorized
     per frame (lexsort + reduceat), semantically identical to
     ``detector.boxes_from_labels``.  The adaptive threshold's
     median/percentile use NumPy's introselect with the same numerics as
     ``detector.detect``.
  4. **knob5 change metric** -- pairwise changed-pixel counts between clip
     frames in one device pass; drop patterns for every DIFF_THRESHOLD are
     derived from the matrix with ``frame_difference``'s exact semantics.

``characterization.characterize`` drives this engine by default and keeps
the per-frame NumPy path as the reference engine.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.core import detector as det
from repro_torch.core import knobs as K
from repro_torch.device import resolve_device
from repro_torch.kernels import frame_knobs as FK

__all__ = ["GridCharacterization", "WireSizeProxy", "run_grid",
           "refresh_tables", "PIXEL_DELTA"]

PIXEL_DELTA = 8.0        # knobs.frame_difference's noise-robust change delta
_FRAME_BUCKET = 16       # frame-axis padding: every group sees one shape
_MIN_WIRE_BYTES = 16.0   # proxy floor: a deflate stream is never smaller


# =============================================================================
# Device stages
# =============================================================================


def _payload_gray(payload: torch.Tensor) -> torch.Tensor:
    """Detector gray plane of a [..., P, oh, ow] payload batch (the same
    channel weights as ``detector._to_gray``; packed yuv/gray payloads are
    their own gray plane)."""
    if payload.shape[-3] == 3:
        return (0.114 * payload[..., 0, :, :].to(torch.float32)
                + 0.587 * payload[..., 1, :, :].to(torch.float32)
                + 0.299 * payload[..., 2, :, :].to(torch.float32))
    return payload[..., 0, :, :].to(torch.float32)


def _payload_diff(payload: torch.Tensor) -> torch.Tensor:
    """Detector background diff of a [S, 1 + n, P, oh, ow] payload batch:
    ``|gray(frame i) - gray(frame 0)|`` for i = 1..n (frame 0 is the
    background)."""
    gray = _payload_gray(payload)
    return (gray[:, 1:] - gray[:, :1]).abs()


def _label_group(diff: torch.Tensor, eff: torch.Tensor) -> torch.Tensor:
    """Threshold -> cross dilation -> 4-connected components, batched.

    Labels are min-flat-index per component (the same fixpoint as
    ``detector._label``); background pixels carry the ``gh*gw`` sentinel.
    Pointer jumping (label indirection) accelerates min-propagation from
    O(component diameter) to O(log diameter) rounds.
    """
    s, f, gh, gw = diff.shape
    mask = diff > eff[:, :, None, None]
    m = mask.clone()
    m[:, :, 1:, :] |= mask[:, :, :-1, :]
    m[:, :, :-1, :] |= mask[:, :, 1:, :]
    m[:, :, :, 1:] |= mask[:, :, :, :-1]
    m[:, :, :, :-1] |= mask[:, :, :, 1:]

    big = gh * gw
    mm = m.reshape(s * f, gh, gw)
    iota = torch.arange(big, dtype=torch.int32,
                        device=diff.device).reshape(gh, gw)
    ids0 = torch.where(mm, iota, big)
    pad_tail = torch.full((s * f, 1), big, dtype=torch.int32,
                          device=diff.device)

    def prop(ids):
        n = ids.clone()
        n[:, 1:, :] = torch.minimum(n[:, 1:, :], ids[:, :-1, :])
        n[:, :-1, :] = torch.minimum(n[:, :-1, :], ids[:, 1:, :])
        n[:, :, 1:] = torch.minimum(n[:, :, 1:], ids[:, :, :-1])
        n[:, :, :-1] = torch.minimum(n[:, :, :-1], ids[:, :, 1:])
        n = torch.where(mm, n, big)
        flat = torch.cat([n.reshape(s * f, -1), pad_tail], dim=1)
        jumped = torch.gather(flat, 1, n.reshape(s * f, -1).long())
        return torch.where(mm, torch.minimum(n, jumped.reshape(n.shape)), big)

    prev, ids = ids0, prop(ids0)
    while bool((ids != prev).any()):
        prev, ids = ids, prop(ids)
    return ids.reshape(s, f, gh, gw)


def _change_counts(frames: torch.Tensor) -> torch.Tensor:
    """Pairwise knob5 change counts: out[i, j] = #pixels of frame i whose
    channel-mean abs-difference from frame j exceeds PIXEL_DELTA."""
    n = frames.shape[0]
    out = torch.empty((n, n), dtype=torch.int32, device=frames.device)
    for j in range(n):
        d = FK._channel_mean_absdiff(frames, frames[j][None])
        out[:, j] = (d > PIXEL_DELTA).sum((1, 2)).to(torch.int32)
    return out


# =============================================================================
# Wire-size proxy (byte-delta features -> calibrated deflate estimate)
# =============================================================================


@dataclasses.dataclass
class WireSizeProxy:
    """Per-(colorspace, knob4-on/off) linear model: zlib_level1_bytes ~=
    coeffs . [n_bytes, feats(6), 1].  Calibrated per characterization run on
    one real deflate measurement per (resolution, colorspace, blur, artifact)
    combo, so the estimate tracks the scene's actual texture statistics.
    Artifact-removed payloads (mostly zeros, long deflate runs) live in a
    different compression regime than dense ones, hence the separate fit."""
    coeffs: np.ndarray                  # [3, 2, 8]
    median_rel_err: float               # on the calibration pairs
    max_rel_err: float

    def predict(self, cs: int, payload_bytes: int, feats: np.ndarray, *,
                art: bool = False) -> np.ndarray:
        x = np.concatenate([
            np.full(feats.shape[:-1] + (1,), float(payload_bytes)),
            np.asarray(feats, np.float64),
            np.ones(feats.shape[:-1] + (1,))], axis=-1)
        return np.maximum(x @ self.coeffs[cs, int(art)], _MIN_WIRE_BYTES)


def _fit_proxy(samples: list[tuple[int, int, int, np.ndarray, int]]
               ) -> WireSizeProxy:
    """samples: (cs, art, payload_bytes, feats[6], zlib_bytes) rows."""
    coeffs = np.zeros((3, 2, FK.N_PROXY_FEATURES + 2))
    rels: list[float] = []
    for cs in range(3):
        for art in range(2):
            rows = [s for s in samples if s[0] == cs and (s[1] > 0) == art]
            if not rows:
                continue
            a = np.stack([np.concatenate([[n], f, [1.0]])
                          for _, _, n, f, _ in rows])
            y = np.asarray([z for *_, z in rows], np.float64)
            coeffs[cs, art], *_ = np.linalg.lstsq(a, y, rcond=None)
            pred = np.maximum(a @ coeffs[cs, art], _MIN_WIRE_BYTES)
            rels.extend(np.abs(pred - y) / np.maximum(y, 1.0))
    rels_arr = np.asarray(rels) if rels else np.zeros(1)
    return WireSizeProxy(coeffs, float(np.median(rels_arr)),
                         float(rels_arr.max()))


def _wire_payload(payload_sf: np.ndarray, cs: int) -> np.ndarray:
    """Planes -> the exact on-the-wire byte layout (interleaved for BGR)."""
    if cs == FK.CS_BGR:
        return np.ascontiguousarray(np.moveaxis(payload_sf, 0, -1))
    return np.ascontiguousarray(payload_sf[0])


# =============================================================================
# The engine
# =============================================================================


@dataclasses.dataclass
class GridCharacterization:
    """Everything ``characterize()`` needs, for every (resolution,
    colorspace, blur, artifact) combo over the calibration clip.  Combos
    are 4-tuples; without ``include_artifact`` the artifact slot is 0."""
    combos: tuple[tuple[int, int, int, int], ...]
    dets: dict[tuple[int, int, int, int], list[np.ndarray]]  # boxes, orig coords
    sizes: dict[tuple[int, int, int, int], np.ndarray]       # [F] proxy bytes
    change_counts: np.ndarray                            # [F, F] int32
    pixels: int                                          # H*W of the camera
    proxy: WireSizeProxy
    zlib_calls: int
    include_artifact: bool = False

    def change_fraction(self, i: int, j: int) -> float:
        """frame_difference's dissimilarity between clip frames i and j,
        bit-equal to the host computation (integer count / pixel count)."""
        return float(self.change_counts[i, j]) / self.pixels

    def drop_pattern(self, threshold: float) -> np.ndarray:
        """knob5 drop decisions over the clip for one DIFF_THRESHOLD, with
        ``frame_difference``'s exact walk semantics (compare against the
        last *sent* frame; threshold < 0 disables)."""
        n = self.change_counts.shape[0]
        drops = np.zeros(n, bool)
        if threshold < 0.0:
            return drops
        last: int | None = None
        for i in range(n):
            if last is not None and self.change_fraction(i, last) <= threshold:
                drops[i] = True
            else:
                last = i
        return drops


def _segment_boxes_batch(labels: np.ndarray, diff: np.ndarray, *,
                         background_label: int, sy: float, sx: float,
                         min_px: float) -> list[np.ndarray]:
    """Segment-vectorized twin of ``detector.boxes_from_labels`` over a
    whole [B, gh, gw] image batch: ONE lexsort + reduceat pass for every
    component of every image, keyed by (image, label).  Same semantics per
    image (ascending-label order, half-maximum refinement via the
    95th-percentile peak with linear interpolation); agreement with the
    host helper is asserted by the characterization oracle tests."""
    n_img, gh, gw = labels.shape
    flat = labels.reshape(n_img, -1)
    fg_img, fg_pix = np.nonzero(flat != background_label)
    empty = np.zeros((0, 4), np.float32)
    if not fg_img.size:
        return [empty] * n_img
    big = gh * gw
    lab = flat[fg_img, fg_pix].astype(np.int64)
    d = diff.reshape(n_img, -1)[fg_img, fg_pix]
    key = fg_img * np.int64(big + 1) + lab
    order = np.lexsort((d, key))
    key_s, d_s = key[order], d[order]
    starts = np.flatnonzero(np.r_[True, key_s[1:] != key_s[:-1]])
    ends = np.append(starts[1:], key_s.size)
    lens = ends - starts
    keep = lens >= min_px
    # per-segment 95th percentile of diff (d is sorted within each segment)
    v = (lens - 1) * 0.95
    lo = np.floor(v).astype(np.int64)
    frac = v - lo
    a = d_s[starts + lo]
    b = d_s[np.minimum(starts + lo + 1, ends - 1)]
    peak = a + frac * (b - a)
    strong = d_s >= 0.5 * np.repeat(peak, lens)
    n_strong = np.add.reduceat(strong, starts)
    sel = strong | np.repeat(n_strong < 2, lens)
    ys, xs = np.divmod(fg_pix[order], gw)
    ymin = np.minimum.reduceat(np.where(sel, ys, big), starts)[keep]
    ymax = np.maximum.reduceat(np.where(sel, ys, -1), starts)[keep]
    xmin = np.minimum.reduceat(np.where(sel, xs, big), starts)[keep]
    xmax = np.maximum.reduceat(np.where(sel, xs, -1), starts)[keep]
    boxes = np.stack([ymin * sy, xmin * sx, (ymax + 1) * sy,
                      (xmax + 1) * sx], axis=1).astype(np.float32)
    # split back per image: segments are sorted by (image, label)
    seg_img = fg_img[order][starts][keep]
    bounds = np.searchsorted(seg_img, np.arange(n_img + 1))
    return [boxes[bounds[i]:bounds[i + 1]] for i in range(n_img)]


def _segment_boxes(labels: np.ndarray, diff: np.ndarray, *,
                   background_label: int, sy: float, sx: float,
                   min_px: float) -> np.ndarray:
    """Single-image convenience wrapper over ``_segment_boxes_batch``."""
    return _segment_boxes_batch(labels[None], diff[None],
                                background_label=background_label,
                                sy=sy, sx=sx, min_px=min_px)[0]


def _label_host(mask: np.ndarray) -> tuple[np.ndarray, int]:
    """4-connected labeling of a [B, gh, gw] bool batch via scipy's C
    implementation (raster-discovery label order == the ascending
    min-flat-index order of the device labeler)."""
    from scipy import ndimage               # declared dep; fallback below
    out = np.empty(mask.shape, np.int32)
    for i in range(mask.shape[0]):
        ndimage.label(mask[i], output=out[i])
    return out, 0                                   # background label


def run_grid(background: np.ndarray, frames: list[np.ndarray], *,
             detector_thresh: float = 28.0, min_area: int = 12,
             include_artifact: bool = False,
             device: "str | torch.device | None" = None
             ) -> GridCharacterization:
    """Characterize every (resolution, colorspace, blur[, artifact]) combo
    over a clip.

    ``background``/``frames``: uint8 [H, W, 3] with even H, W (the grid
    path needs 4:2:0-subsample-able planes; ``characterize`` takes the NumPy
    reference engine otherwise).  ``include_artifact`` triples the settings
    batch of every group with knob4's movers/contours modes, run on the
    device against the raw background.  ``device`` defaults to ``"cuda"``
    (the CUDA kernel and the device labeler); ``device="cpu"`` runs the
    kernel's plain version and scipy's labeler.

    Device work is dispatched with a bounded lookahead (launches are
    asynchronous), so transforms for the next groups overlap the host-side
    scoring of the current one without holding all 15 groups' payload/diff
    buffers resident at once.
    """
    dev = resolve_device(device)
    h, w = background.shape[:2]
    if background.ndim != 3 or background.shape[2] != 3 or h % 2 or w % 2:
        raise ValueError(f"grid engine needs even-dim 3-channel frames, "
                         f"got {background.shape}")

    art_modes = (0, 1, 2) if include_artifact else (0,)
    n_clip = len(frames)
    n_real = n_clip + 1                                  # +1: background
    n_pad = -(-n_real // _FRAME_BUCKET) * _FRAME_BUCKET
    stack = np.stack([background] + list(frames)
                     + [background] * (n_pad - n_real)).astype(np.uint8)
    fj = torch.as_tensor(stack).to(dev)
    prevj = torch.cat([fj[:1], fj[:-1]])
    bgj = fj[0]
    # knob4 must not fire on frame 0 (the detector's background payload)
    # or on the padding tail
    enable = np.zeros(n_pad, np.int32)
    enable[1:n_real] = 1
    enj = torch.as_tensor(enable).to(dev)

    change_counts_dev = _change_counts(fj[1:n_real])

    def dispatch(res_cs: tuple[int, int]):
        res, cs = res_cs
        plan = FK.build_transform_plan(
            h, w, scale=K.RESOLUTION_SCALES[res], cs=cs,
            blur_ks=K.BLUR_KERNELS, art_modes=art_modes)
        payload, feats, _ = FK.frame_knob_grid(
            fj, prevj, plan,
            background=bgj if include_artifact else None,
            art_enable=enj if include_artifact else None, device=dev)
        diff = _payload_diff(payload[:, :n_clip + 1])    # [S, F, gh, gw]
        return res_cs, plan, (payload, feats, diff)

    todo = [(res, cs) for res in range(len(K.RESOLUTION_SCALES))
            for cs in range(len(K.COLORSPACES))]
    lookahead = 2
    in_flight = [dispatch(rc) for rc in todo[:lookahead]]

    n_blur = len(K.BLUR_KERNELS)
    dets: dict[tuple[int, int, int, int], list[np.ndarray]] = {}
    feats_all: dict[tuple[int, int, int, int], np.ndarray] = {}
    cal_samples: list[tuple[int, int, int, np.ndarray, int]] = []
    plan_of_cs: dict[tuple[int, int], FK.TransformPlan] = {}

    for gi in range(len(todo)):
        (res, cs), plan, (payload, feats, diff) = in_flight[gi % lookahead]
        if gi + lookahead < len(todo):
            in_flight[gi % lookahead] = dispatch(todo[gi + lookahead])
        plan_of_cs[(res, cs)] = plan
        diff_np = diff.cpu().numpy()                     # [S, F, gh, gw]
        feats_np = feats[:, 1:n_real].cpu().numpy()      # [S, F, 6]
        s_dim, f_dim = diff_np.shape[:2]
        # only the calibration frame of each (blur, artifact) setting ever
        # needs its payload on the host -- slice on the device, don't ship
        # the batch
        cal_idx = np.asarray([1 + (res * s_dim + b) % n_clip
                              for b in range(s_dim)])
        cal_payloads = payload[torch.arange(s_dim, device=dev),
                               torch.as_tensor(cal_idx).to(dev)].cpu().numpy()

        # adaptive threshold: detector.detect's own helper, batched, one
        # introselect pass for both quantiles
        gh, gw = diff_np.shape[2:]
        eff = det.adaptive_threshold(
            diff_np.reshape(s_dim, f_dim, -1), detector_thresh, axis=-1)

        label_on_device = dev.type == "cuda"
        if not label_on_device:
            try:
                mask = det.dilate_cross(diff_np > eff[:, :, None, None])
                ids, bg_label = _label_host(mask.reshape(-1, gh, gw))
            except ImportError:             # no scipy: device labeler works
                label_on_device = True
        if label_on_device:
            ids = _label_group(diff, torch.as_tensor(eff).to(dev))
            ids = ids.cpu().numpy().reshape(s_dim * f_dim, gh, gw)
            bg_label = gh * gw

        sy, sx = h / gh, w / gw
        min_px = max(2.0, min_area / (sy * sx))
        boxes = _segment_boxes_batch(ids, diff_np.reshape(-1, gh, gw),
                                     background_label=bg_label,
                                     sy=sy, sx=sx, min_px=min_px)
        for s_i in range(s_dim):
            art, b = int(plan.art_ids[s_i]), s_i % n_blur
            combo = (res, cs, b, art)
            feats_all[combo] = feats_np[s_i]
            dets[combo] = boxes[s_i * f_dim:s_i * f_dim + n_clip]
            wire = _wire_payload(cal_payloads[s_i], cs)
            cal_samples.append((cs, art, plan.payload_bytes,
                                feats_np[s_i, cal_idx[s_i] - 1],
                                len(zlib.compress(wire.tobytes(), 1))))

    proxy = _fit_proxy(cal_samples)
    sizes = {
        (res, cs, b, art): proxy.predict(
            cs, plan_of_cs[(res, cs)].payload_bytes,
            feats_all[(res, cs, b, art)], art=art > 0)
        for (res, cs, b, art) in feats_all
    }
    return GridCharacterization(
        combos=tuple(sorted(feats_all)), dets=dets, sizes=sizes,
        change_counts=change_counts_dev.cpu().numpy(), pixels=h * w,
        proxy=proxy, zlib_calls=len(cal_samples),
        include_artifact=include_artifact)


# =============================================================================
# Online re-characterization (live tables for the controller)
# =============================================================================


def refresh_tables(background: np.ndarray, frames: list[np.ndarray], *,
                   gts: list[np.ndarray] | None = None,
                   min_accuracy: float = 0.90,
                   include_artifact: bool = False,
                   detector_thresh: float = 28.0,
                   capacity: int | None = None,
                   device: "str | torch.device | None" = None):
    """Re-run the batched sweep over a LIVE clip and emit controller-ready
    tables: ``(CharacterizationTable, ControllerTables)``.

    This is the online (CANS-style) re-characterization entry point: the
    clip is whatever the camera recently published (``CamBroker`` feeds its
    log tail), and -- absent labels -- the full-quality combo's own
    detections act as pseudo-ground-truth, so accuracies are normalized F1
    against the unmodified stream, exactly the quantity the controller
    trades against latency.  Pass ``gts`` to score against real labels
    instead (the offline ``characterize`` path).

    ``capacity`` pads the device tables to a fixed row count so a consumer
    of fixed-shape tables takes refreshed tables without reshaping (see
    ``controller.swap_tables``).  ``device`` is where the sweep runs and the
    tables live (default ``"cuda"``).
    """
    from repro_torch.core import characterization as C
    from repro_torch.core.controller import ControllerTables

    dev = resolve_device(device)
    grid = run_grid(background, frames, detector_thresh=detector_thresh,
                    include_artifact=include_artifact, device=dev)
    if gts is None:
        gts = grid.dets[(0, 0, 0, 0)]
    table = C.table_from_grid(grid, gts, min_accuracy=min_accuracy,
                              include_artifact=include_artifact)
    # provenance: these tables were swept from live frames, not the
    # offline calibration campaign (drift tests / fig12 assert on this)
    table.source = "online-refresh"
    if capacity is not None:
        capacity = max(capacity, len(table.settings))
    return table, ControllerTables.from_table(table, capacity=capacity,
                                              device=dev)
