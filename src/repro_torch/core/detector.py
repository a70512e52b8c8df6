"""The subscriber "machine vision application": a deterministic pedestrian
detector + the paper's exact F1 evaluation protocol (Section 2.4).

OpenPose is not runnable in this environment; the controller only ever
consumes a (wire size -> accuracy) characterization table, so any detector
whose F1 degrades smoothly and monotonically-ish with frame quality exercises
identical machinery.  This one is classical vision, fully deterministic:

    background subtraction -> threshold -> 3x3 dilation -> connected
    components (union-find) -> bounding boxes

Evaluation follows the paper verbatim: each ground-truth box is matched
exclusively to the highest-IoU detection; IoU > 0.5 = true positive;
unmatched detections = false positives; unmatched ground truth = false
negatives; F1 = 2PR/(P+R); reported normalized to the unmodified-frame
baseline F1.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np

from repro_torch.core.api import DeliveredFrame

__all__ = ["detect", "detect_batch", "boxes_from_labels",
           "adaptive_threshold", "dilate_cross", "iou_matrix",
           "match_f1", "normalized_f1"]


def adaptive_threshold(diff: np.ndarray, thresh: float,
                       axis=None) -> np.ndarray:
    """Adaptive detector threshold (scalar or batched along ``axis``).

    Blur/downscale knobs reduce object contrast, so a fixed threshold goes
    blind on degraded streams.  Track the stream's own contrast (45% of the
    near-peak diff) but never drop below the robust noise floor (median
    |diff| estimates sensor noise + texture mismatch).  One quantile pass
    serves both statistics; shared by ``detect`` and the batched
    characterization engine so the two paths cannot desynchronize.
    """
    med, pct = np.percentile(diff, [50.0, 99.8], axis=axis)
    return np.maximum(3.0 * med + 4.0, np.minimum(thresh, 0.45 * pct))


def dilate_cross(mask: np.ndarray) -> np.ndarray:
    """Cheap 4-neighbour (cross) dilation over a [..., gh, gw] bool array,
    so movers aren't speckled.  Shared by ``detect`` and the batched
    characterization engine."""
    m = mask.copy()
    m[..., 1:, :] |= mask[..., :-1, :]
    m[..., :-1, :] |= mask[..., 1:, :]
    m[..., :, 1:] |= mask[..., :, :-1]
    m[..., :, :-1] |= mask[..., :, 1:]
    return m


def _to_gray(frame: np.ndarray) -> np.ndarray:
    if frame.ndim == 2:
        return frame.astype(np.float32)
    if frame.shape[-1] == 1:
        return frame[..., 0].astype(np.float32)
    f = frame.astype(np.float32)
    return 0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2]


def _label(mask: np.ndarray, *, max_iters: int = 512) -> tuple[np.ndarray, int]:
    """4-connected component labeling via vectorized min-label propagation.

    Each foreground pixel starts with a unique id; every iteration each pixel
    takes the min id among itself and its 4 foreground neighbours.  Converges
    in O(component diameter) fully-vectorized passes -- the NumPy analogue of
    the classic iterative CCL, chosen over union-find for speed (the detector
    runs thousands of times during characterization sweeps).
    """
    h, w = mask.shape
    big = np.int64(h * w + 1)
    ids = np.where(mask, np.arange(h * w, dtype=np.int64).reshape(h, w), big)
    for _ in range(max_iters):
        nxt = ids.copy()
        nxt[1:, :] = np.minimum(nxt[1:, :], ids[:-1, :])
        nxt[:-1, :] = np.minimum(nxt[:-1, :], ids[1:, :])
        nxt[:, 1:] = np.minimum(nxt[:, 1:], ids[:, :-1])
        nxt[:, :-1] = np.minimum(nxt[:, :-1], ids[:, 1:])
        nxt = np.where(mask, nxt, big)
        if np.array_equal(nxt, ids):
            break
        ids = nxt
    flat = ids[mask]
    uniq = np.unique(flat)
    remap = {int(u): i + 1 for i, u in enumerate(uniq)}
    labels = np.zeros((h, w), np.int32)
    if len(uniq):
        lut = np.zeros(int(uniq.max()) + 2, np.int32)
        for u, i in remap.items():
            lut[u] = i
        labels[mask] = lut[flat]
    return labels, len(uniq)


def detect(frame: np.ndarray, background: np.ndarray, *,
           thresh: float = 28.0, min_area: int = 12,
           scale_to: tuple[int, int] | None = None) -> np.ndarray:
    """Detect moving objects; returns boxes [N,4] (y0,x0,y1,x1), float32.

    ``scale_to``: if the frame was downscaled/colorspace-packed by the knobs,
    pass the original (H, W) so boxes come back in original coordinates (the
    subscriber knows the camera's native geometry from GetCameraInfo).
    """
    g = _to_gray(frame)
    bh, bw = background.shape[:2]
    gh, gw = g.shape
    bg = _to_gray(background)
    if (gh, gw) != (bh, bw):
        # knob changed geometry: resample background to the frame's grid
        ys = np.clip((np.arange(gh) * bh / gh).astype(np.int64), 0, bh - 1)
        xs = np.clip((np.arange(gw) * bw / gw).astype(np.int64), 0, bw - 1)
        bg = bg[ys][:, xs]
    diff = np.abs(g - bg)
    eff_thresh = float(adaptive_threshold(diff, thresh))
    mask = diff > eff_thresh
    m = dilate_cross(mask)
    labels, _ = _label(m)
    sy = (scale_to[0] / gh) if scale_to else 1.0
    sx = (scale_to[1] / gw) if scale_to else 1.0
    # min_area is defined in ORIGINAL-geometry pixels; convert to this grid.
    min_px = max(2.0, min_area / (sy * sx))
    return boxes_from_labels(labels, diff, background_label=0, sy=sy, sx=sx,
                             min_px=min_px)


def boxes_from_labels(labels: np.ndarray, diff: np.ndarray, *,
                      background_label: int, sy: float = 1.0, sx: float = 1.0,
                      min_px: float = 2.0) -> np.ndarray:
    """Component bounding boxes from a labeled mask, with half-maximum
    refinement.  Shared by the host detector and the batched
    characterization engine (``core.grid_engine``), whose device labeling
    emits min-flat-index component ids with ``gh*gw`` as background.

    Components are emitted in ascending label order, so the host path
    (labels 1..n) and the device path (min-pixel-index labels) produce
    identical box lists for identical component partitions.
    """
    gh, gw = labels.shape
    flat = labels.ravel()
    fg = np.flatnonzero(flat != background_label)
    boxes = []
    if fg.size:
        order = fg[np.argsort(flat[fg], kind="stable")]
        sorted_lab = flat[order]
        starts = np.flatnonzero(np.r_[True, sorted_lab[1:] != sorted_lab[:-1]])
        ends = np.append(starts[1:], sorted_lab.size)
        ys_all, xs_all = np.divmod(order, gw)
        diff_flat = diff.ravel()[order]
        for s0, e0 in zip(starts, ends):
            if e0 - s0 < min_px:
                continue
            ys, xs = ys_all[s0:e0], xs_all[s0:e0]
            # Half-maximum box refinement: blur (and the dilation above)
            # symmetrically inflates a component's support, which tanks IoU
            # for small objects.  The true object boundary sits near half the
            # component's peak contrast, so bound the box on those pixels.
            d = diff_flat[s0:e0]
            peak = np.percentile(d, 95)
            strong = d >= 0.5 * peak
            if strong.sum() >= 2:
                ys, xs = ys[strong], xs[strong]
            boxes.append((ys.min() * sy, xs.min() * sx, (ys.max() + 1) * sy,
                          (xs.max() + 1) * sx))
    return np.asarray(boxes, np.float32).reshape(-1, 4)


def detect_batch(batch, background, *,
                 scale_to: tuple[int, int] | None = None,
                 thresh: float = 28.0, min_area: int = 12,
                 ) -> list[tuple[DeliveredFrame, np.ndarray]]:
    """Run the detector over a v2 ``FrameBatch`` (or any iterable of
    ``DeliveredFrame``) in one call -- the multi-camera fan-in consumer.

    ``background`` is either one array shared by every frame or a callable
    ``(DeliveredFrame) -> np.ndarray`` resolving the per-camera (and per-knob-
    setting) background model.  Dropped frames are skipped (at-most-once);
    returns ``[(delivered_frame, boxes[N,4]), ...]`` in batch order.
    """
    frames: Iterable[DeliveredFrame] = getattr(batch, "delivered", batch)
    bg_for: Callable[[DeliveredFrame], np.ndarray] = (
        background if callable(background) else (lambda _d: background))
    out: list[tuple[DeliveredFrame, np.ndarray]] = []
    for d in frames:
        if d.frame is None:
            continue
        out.append((d, detect(np.asarray(d.frame), bg_for(d), thresh=thresh,
                              min_area=min_area, scale_to=scale_to)))
    return out


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of two box sets [Na,4] x [Nb,4] -> [Na,Nb]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    y0 = np.maximum(a[:, None, 0], b[None, :, 0])
    x0 = np.maximum(a[:, None, 1], b[None, :, 1])
    y1 = np.minimum(a[:, None, 2], b[None, :, 2])
    x1 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(y1 - y0, 0, None) * np.clip(x1 - x0, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


def match_f1(gt: np.ndarray, det: np.ndarray, *, iou_thresh: float = 0.5
             ) -> tuple[int, int, int]:
    """Greedy exclusive matching (paper protocol).  Returns (TP, FP, FN)."""
    iou = iou_matrix(gt, det)
    tp = 0
    used_det: set[int] = set()
    # match each GT to its highest-IoU unused detection, best matches first
    pairs = [(iou[i, j], i, j) for i in range(len(gt)) for j in range(len(det))]
    pairs.sort(reverse=True)
    used_gt: set[int] = set()
    for v, i, j in pairs:
        if v <= iou_thresh:
            break
        if i in used_gt or j in used_det:
            continue
        used_gt.add(i); used_det.add(j); tp += 1
    fp = len(det) - len(used_det)
    fn = len(gt) - len(used_gt)
    return tp, fp, fn


def f1_from_counts(tp: int, fp: int, fn: int) -> float:
    if tp == 0:
        return 0.0
    p = tp / (tp + fp)
    r = tp / (tp + fn)
    return 2 * p * r / (p + r)


def normalized_f1(frames_gt_det: list[tuple[np.ndarray, np.ndarray]],
                  baseline: list[tuple[np.ndarray, np.ndarray]]) -> float:
    """Aggregate F1 over a clip, normalized to the unmodified-frame baseline.

    Dropped frames (knob5) contribute their ground truth as false negatives
    -- the application never saw them (at-most-once delivery).
    """
    tp = fp = fn = 0
    for gt, det in frames_gt_det:
        a, b, c = match_f1(gt, det)
        tp += a; fp += b; fn += c
    btp = bfp = bfn = 0
    for gt, det in baseline:
        a, b, c = match_f1(gt, det)
        btp += a; bfp += b; bfn += c
    f1 = f1_from_counts(tp, fp, fn)
    bf1 = f1_from_counts(btp, bfp, bfn)
    return f1 / bf1 if bf1 > 0 else 0.0
