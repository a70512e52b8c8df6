"""Video-frame quality tuning knobs (paper Section 2.3.1).

Five lossy transforms shrink a frame's wire size at some accuracy cost:

  knob1 resolution        -- downscale, aspect ratio preserved (<= 84% smaller)
  knob2 colorspace        -- BGR->Gray / chroma-subsampled YUV (<= 62% smaller)
  knob3 blur              -- normalized box filter, k in {5,8,10,15} (<= 46%)
  knob4 artifact removal  -- background subtraction, keep moving objects (<=98%)
  knob5 frame differencing-- drop frames similar to the last sent one (<= 40%)

The paper measures sizes after the camera's codec; we measure the *actual*
compressed wire size (zlib level 1 over the transformed payload), so every
knob has a genuine, mechanistic effect on bytes-on-the-wire: blur removes
high-frequency content (smaller entropy -> smaller deflate output), gray drops
channels, downscaling drops pixels, artifact removal zeroes the background
(long runs -> tiny deflate output), frame differencing sends nothing at all.

Paper fidelity notes:
  * knob4 exists but is EXCLUDED from the controller's characterization table
    by default, mirroring the paper ("due to the computationally intensive
    nature of knob 4, we exclude knob 4 to maintain the image modification
    overheads to under 10 ms").
  * knob5's threshold semantics follow the paper: 0 = only pixel-identical
    frames dropped; larger thresholds drop more.

Host path is NumPy (it runs "on the IoT camera node");
`repro_torch.kernels.frame_knobs` runs the same transforms over the whole
knob grid on the device (a hand-written CUDA kernel beside its plain
PyTorch version).
"""

from __future__ import annotations

import dataclasses
import itertools
import zlib

import numpy as np

__all__ = [
    "KnobSetting", "KNOB_GRID", "apply_knobs", "transform_frame", "wire_size",
    "enumerate_settings", "frame_difference", "change_fraction",
    "TransformMemo",
    "RESOLUTION_SCALES", "COLORSPACES", "BLUR_KERNELS", "DIFF_THRESHOLDS",
]

RESOLUTION_SCALES = (1.0, 0.6833, 0.5, 0.3333, 0.25)   # paper: 1312x736..480x256 of 1920x1080
COLORSPACES = ("bgr", "gray", "yuv420")                  # identity / -66% / -50%
BLUR_KERNELS = (0, 5, 8, 10, 15)                         # 0 = off
ARTIFACT_MODES = ("off", "movers", "contours")           # paper knob4 settings
# knob5 thresholds: fraction of changed pixels below which a frame is dropped.
# -1 = off; 0 = only pixel-identical frames dropped (paper's "0" endpoint).
# The paper's absolute 0..0.72 scale is dataset-specific (their dissimilarity
# metric saturates differently on JAAD/DukeMTMC footage); these values are the
# equivalent operating points for the synthetic scenes -- chosen so simple
# dynamics sees up to ~40% drops at the top setting (paper Section 2.3.1(5)).
DIFF_THRESHOLDS = (-1.0, 0.0, 0.01, 0.03, 0.06, 0.12)


@dataclasses.dataclass(frozen=True, order=True)
class KnobSetting:
    """One point in the knob grid. Indices into the tuples above."""
    resolution: int = 0
    colorspace: int = 0
    blur: int = 0
    artifact: int = 0
    diff: int = 0

    def describe(self) -> str:
        return (f"res={RESOLUTION_SCALES[self.resolution]:.2f}"
                f"/cs={COLORSPACES[self.colorspace]}"
                f"/blur={BLUR_KERNELS[self.blur]}"
                f"/art={ARTIFACT_MODES[self.artifact]}"
                f"/diff={DIFF_THRESHOLDS[self.diff]:.2f}")

    @property
    def overhead_ms(self) -> float:
        """Modeled per-frame modification cost on the camera node (ms).

        Calibrated to the paper's numbers: the cheap knobs sum to <10 ms;
        knob4 (artifact removal) alone exceeds 10 ms, which is why the paper
        excludes it.
        """
        # calibrated to the paper's camera-node measurements: the cheap
        # knob combinations stay under 10 ms (their stated budget), knob4
        # alone blows it -- which is why the paper excludes knob4.
        cost = 1.0                                    # buffer in/out
        if RESOLUTION_SCALES[self.resolution] < 1.0:
            cost += 3.0
        if COLORSPACES[self.colorspace] != "bgr":
            cost += 2.0
        if BLUR_KERNELS[self.blur]:
            cost += 2.2 + 0.2 * BLUR_KERNELS[self.blur]
        if ARTIFACT_MODES[self.artifact] != "off":
            cost += 14.0                              # the expensive one
        if DIFF_THRESHOLDS[self.diff] >= 0.0:
            cost += 1.5
        return cost


KNOB_GRID = tuple(
    KnobSetting(r, c, b, a, d)
    for r, c, b, a, d in itertools.product(
        range(len(RESOLUTION_SCALES)), range(len(COLORSPACES)),
        range(len(BLUR_KERNELS)), range(len(ARTIFACT_MODES)),
        range(len(DIFF_THRESHOLDS)))
)


def enumerate_settings(*, include_artifact: bool = False) -> tuple[KnobSetting, ...]:
    """The knob grid the controller characterizes over (paper: knob4 excluded)."""
    if include_artifact:
        return KNOB_GRID
    return tuple(s for s in KNOB_GRID if s.artifact == 0)


# -----------------------------------------------------------------------------
# Individual transforms (NumPy, uint8 HxWxC frames)
# -----------------------------------------------------------------------------


def _resize_area(frame: np.ndarray, scale: float) -> np.ndarray:
    """Area-style resize (box sample), aspect preserved.  uint8 in/out."""
    if scale >= 0.999:
        return frame
    h, w = frame.shape[:2]
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    ys = np.clip((np.arange(nh) + 0.5) / scale - 0.5, 0, h - 1)
    xs = np.clip((np.arange(nw) + 0.5) / scale - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64); y1 = np.minimum(y0 + 1, h - 1)
    x0 = np.floor(xs).astype(np.int64); x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]; wx = (xs - x0)[None, :, None]
    f = frame.astype(np.float32)
    if f.ndim == 2:
        f = f[..., None]
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out if frame.ndim == 3 else out[..., 0]


def _to_colorspace(frame: np.ndarray, mode: str) -> np.ndarray:
    """Colorspace knob.  Returns the representation actually shipped."""
    if mode == "bgr" or frame.ndim == 2:
        return frame
    f = frame.astype(np.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 0.114 * b + 0.587 * g + 0.299 * r
    if mode == "gray":
        return np.clip(np.round(y), 0, 255).astype(np.uint8)
    if mode == "yuv420":
        u = 0.492 * (b - y) + 128.0
        v = 0.877 * (r - y) + 128.0
        u2 = u[::2, ::2]; v2 = v[::2, ::2]   # 4:2:0 chroma subsample
        planes = [np.clip(np.round(p), 0, 255).astype(np.uint8)
                  for p in (y, u2, v2)]
        # Pack planes into one 2-D payload (Y on top, U|V side by side
        # below).  For odd widths the U|V row is one column wider than Y
        # (uw = ceil(w/2), so 2*uw = w + 1); the payload widens to fit the
        # full V plane instead of silently truncating its last column, and
        # Y pads with zeros.  Even widths pack exactly (payload width = w).
        h, w = planes[0].shape
        uh, uw = planes[1].shape
        pw = max(w, 2 * uw)
        top = np.zeros((h, pw), np.uint8)
        top[:, :w] = planes[0]
        bottom = np.zeros((uh, pw), np.uint8)
        bottom[:, :uw] = planes[1]
        bottom[:, uw:2 * uw] = planes[2]
        return np.concatenate([top, bottom], axis=0)
    raise ValueError(mode)


def _box_blur(frame: np.ndarray, k: int) -> np.ndarray:
    """Normalized k x k box filter via separable cumulative sums."""
    if k <= 1:
        return frame
    f = frame.astype(np.float32)
    squeeze = f.ndim == 2
    if squeeze:
        f = f[..., None]
    pad = k // 2
    fpad = np.pad(f, ((pad, k - 1 - pad), (0, 0), (0, 0)), mode="edge")
    c = np.cumsum(fpad, axis=0)
    c = np.concatenate([np.zeros((1,) + c.shape[1:], c.dtype), c], axis=0)
    f = (c[k:] - c[:-k]) / k
    fpad = np.pad(f, ((0, 0), (pad, k - 1 - pad), (0, 0)), mode="edge")
    c = np.cumsum(fpad, axis=1)
    c = np.concatenate([np.zeros((c.shape[0], 1, c.shape[2]), c.dtype), c], axis=1)
    f = (c[:, k:] - c[:, :-k]) / k
    out = np.clip(np.round(f), 0, 255).astype(np.uint8)
    return out[..., 0] if squeeze else out


def _artifact_removal(frame: np.ndarray, background: np.ndarray, mode: str,
                      thresh: float = 18.0) -> np.ndarray:
    """knob4: keep movers (or just their contours), zero the static background."""
    if mode == "off":
        return frame
    f = frame.astype(np.float32)
    b = background.astype(np.float32)
    if f.ndim == 3:
        diff = np.abs(f - b).mean(axis=-1)
    else:
        diff = np.abs(f - b)
    mask = (diff > thresh)
    # cheap dilation (3x3) so movers aren't speckled
    m = mask.copy()
    m[1:, :] |= mask[:-1, :]; m[:-1, :] |= mask[1:, :]
    m[:, 1:] |= mask[:, :-1]; m[:, :-1] |= mask[:, 1:]
    if mode == "contours":
        # boundary = mask minus its erosion
        er = m.copy()
        er[1:, :] &= m[:-1, :]; er[:-1, :] &= m[1:, :]
        er[:, 1:] &= m[:, :-1]; er[:, :-1] &= m[:, 1:]
        m = m & ~er
    out = frame.copy()
    if frame.ndim == 3:
        out[~m] = 0
    else:
        out[~m] = 0
    return out


def change_fraction(frame: np.ndarray, last_sent: np.ndarray | None, *,
                    pixel_delta: float = 8.0) -> float | None:
    """knob5's dissimilarity metric: fraction of pixels whose absolute
    difference from the last *sent* frame exceeds ``pixel_delta`` (a noise-
    robust change metric: sensor noise flips <1% of pixels past 8 grey
    levels, while genuine motion sweeps contiguous regions).  0 = pixel-
    identical, 1 = every pixel changed; None when there is no comparable
    previous frame.  Doubles as the broker's scene-ACTIVITY observation:
    the drift monitor compares the live stream's change fractions against
    the characterization clip's (``CharacterizationTable.activity``) to
    spot scene regime shifts that barely move wire sizes."""
    if last_sent is None or frame.shape != last_sent.shape:
        return None
    d = np.abs(frame.astype(np.float32) - last_sent.astype(np.float32))
    if d.ndim == 3:
        d = d.mean(axis=-1)
    return float((d > pixel_delta).mean())


def frame_difference(frame: np.ndarray, last_sent: np.ndarray | None,
                     threshold: float, *, pixel_delta: float = 8.0) -> bool:
    """knob5: True = DROP this frame (similar to the last sent one).

    ``change_fraction`` compared against ``threshold``; threshold < 0
    disables the knob.
    """
    if threshold < 0.0:
        return False
    changed = change_fraction(frame, last_sent, pixel_delta=pixel_delta)
    return changed is not None and changed <= threshold


# -----------------------------------------------------------------------------
# The composite knob pipeline + wire size
# -----------------------------------------------------------------------------


@dataclasses.dataclass
class KnobResult:
    frame: np.ndarray | None      # None => dropped by frame differencing
    wire_bytes: int               # 0 if dropped
    overhead_ms: float


def wire_size(frame: np.ndarray) -> int:
    """Actual bytes-on-the-wire: deflate(level=1) of the payload."""
    return len(zlib.compress(np.ascontiguousarray(frame).tobytes(), 1))


def transform_frame(frame: np.ndarray, setting: KnobSetting) -> np.ndarray:
    """The lossy transform pipeline (colorspace -> resolution -> blur), i.e.
    everything except the drop decision (knob5) and artifact removal (knob4).

    Also used by subscribers to push their *background model* through the same
    degradation the stream experienced (background subtraction runs against
    the received stream's statistics, not the pristine camera output).
    """
    out = _to_colorspace(frame, COLORSPACES[setting.colorspace])
    out = _resize_area(out, RESOLUTION_SCALES[setting.resolution])
    return _box_blur(out, BLUR_KERNELS[setting.blur])


class TransformMemo:
    """Per-setting memo of ``transform_frame`` over one fixed source image.

    Background models are static while a knob setting is live, but consumers
    (subscriber-side detectors, the reference characterization sweep, the
    broker's ``degraded_background``) need the background pushed through the
    same degradation as the stream -- recomputing that per *frame* is pure
    waste.  The memo keys on the transform-relevant knobs only (resolution,
    colorspace, blur), so all diff/artifact variants of a setting share one
    entry.
    """

    def __init__(self, image: np.ndarray):
        self._image = image
        self._memo: dict[tuple[int, int, int], np.ndarray] = {}

    @property
    def image(self) -> np.ndarray:
        return self._image

    def get(self, setting: KnobSetting) -> np.ndarray:
        key = (setting.resolution, setting.colorspace, setting.blur)
        out = self._memo.get(key)
        if out is None:
            out = transform_frame(self._image, KnobSetting(*key))
            self._memo[key] = out
        return out


def apply_knobs(frame: np.ndarray, setting: KnobSetting, *,
                background: np.ndarray | None = None,
                last_sent: np.ndarray | None = None) -> KnobResult:
    """Apply one knob setting to one frame.  Order mirrors the paper's
    pipeline: differencing decides drop first (cheapest exit), then artifact
    removal, colorspace, resolution, blur."""
    if frame_difference(frame, last_sent, DIFF_THRESHOLDS[setting.diff]):
        return KnobResult(None, 0, setting.overhead_ms)
    out = frame
    if ARTIFACT_MODES[setting.artifact] != "off":
        if background is None:
            background = np.zeros_like(frame)
        out = _artifact_removal(out, background, ARTIFACT_MODES[setting.artifact])
    out = transform_frame(out, setting)
    return KnobResult(out, wire_size(out), setting.overhead_ms)
