"""Frame-quality kernels on the card: the knob grid (one pass over a clip
evaluates every setting of one (resolution, colorspace) group), and the
fixed-function ``frame_knobs`` of the camera node.

``frame_knobs`` takes gray planes ``[N, H, W]`` and their previous frames
and returns a 2x2 mean pool with an edge-clamped k-tap box blur (vertical,
then horizontal) and the knob5 changed-pixel fraction; ``frame_knobs_plain``
is its plain PyTorch version, and ``csrc/frame_knobs.cu`` its kernel.

The knob grid applies, per (setting, frame), in the order of the host
pipeline:

  1. knob5 change metric on the raw frame (channel-mean ``|f - prev|`` above
     ``pixel_delta``), measured before knob4;
  2. knob4 artifact removal against a background frame (channel-mean
     ``|f - bg| > 18``, cross dilation, keep movers or just their contours,
     zero the rest), selected per setting and gated per frame;
  3. knob2 colorspace: BGR planes / gray / packed 4:2:0 YUV (Y on top, U|V
     below: the wire layout of ``knobs._to_colorspace``);
  4. knob1 bilinear resize (vertical then horizontal), uint8 round/clip;
  5. knob3 box blur (vertical then horizontal), uint8 round/clip;
  6. six wire-size proxy features per payload (sum log2(1+|d|), zero-delta
     count, |d|<=2 count, for horizontal and vertical byte deltas).

Three pieces of the grid live here:

``build_transform_plan``     the host half: dense per-axis operators of one
                             group, plus their band form (start, length,
                             weights per output row) derived from them.
``frame_knob_grid_plain``    plain PyTorch ops that mirror the reference
                             stage for stage (dense einsums over the plan's
                             operators); the CPU path and the yardstick.
``frame_knob_grid``          the wrapper of the hand-written CUDA kernel
                             (``csrc/frame_knob_grid.cu``): on a CUDA device
                             it launches the kernel, on the CPU it takes the
                             plain version.  The kernel's per-plan operands
                             (``GridOperands``) are derived with the plan
                             and uploaded at its first call on a device.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["TransformPlan", "Band", "GridOperands",
           "build_transform_plan", "band_form",
           "frame_knob_grid", "frame_knob_grid_plain", "resize_operator",
           "blur_operator", "proxy_features", "proxy_features_host",
           "N_PROXY_FEATURES", "ARTIFACT_THRESH", "CS_BGR", "CS_GRAY",
           "CS_YUV420", "frame_knobs", "frame_knobs_plain",
           "KNOBS_KERNEL_DTYPES"]

N_PROXY_FEATURES = 6   # (log2-sum, zero-count, <=2-count) x (dx, dy)
ARTIFACT_THRESH = 18.0  # knobs._artifact_removal's default mask threshold

# Colorspace ids (match knobs.COLORSPACES order).
CS_BGR, CS_GRAY, CS_YUV420 = 0, 1, 2


def resize_operator(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """One axis of ``knobs._resize_area`` as an [n_out, n_in] f32 operator.

    Row i carries the two bilinear taps of output sample i (edge-clamped,
    half-pixel-centre aligned).  ``scale >= 0.999`` yields the identity, so
    the full-resolution setting is exact pass-through.
    """
    if scale >= 0.999:
        return np.eye(n_in, dtype=np.float32)
    xs = np.clip((np.arange(n_out) + 0.5) / scale - 0.5, 0, n_in - 1)
    x0 = np.floor(xs).astype(np.int64)
    x1 = np.minimum(x0 + 1, n_in - 1)
    wx = (xs - x0).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    np.add.at(m, (np.arange(n_out), x0), 1.0 - wx)
    np.add.at(m, (np.arange(n_out), x1), wx)
    return m


def blur_operator(n: int, k: int) -> np.ndarray:
    """``knobs._box_blur`` along one axis as an [n, n] edge-clamped band
    matrix (identity for k <= 1)."""
    m = np.zeros((n, n), np.float32)
    if k <= 1:
        np.fill_diagonal(m, 1.0)
        return m
    pad = k // 2
    rows = np.arange(n)
    for off in range(-pad, k - pad):
        np.add.at(m, (rows, np.clip(rows + off, 0, n - 1)),
                  np.float32(1.0 / k))
    return m


@dataclasses.dataclass(frozen=True)
class Band:
    """Band form of a stack of [n_out, n_in] operators: output row i reads
    inputs ``start[i] .. start[i] + length[i] - 1`` with ``weight[i, :length[i]]``
    (the operator's own f32 entries, zero-padded to ``k`` columns)."""
    start: np.ndarray    # i32 [..., n_out]
    length: np.ndarray   # i32 [..., n_out]
    weight: np.ndarray   # f32 [..., n_out, k]

    @property
    def k(self) -> int:
        return self.weight.shape[-1]

    def dense(self, n_in: int) -> np.ndarray:
        """The operators back in dense [..., n_out, n_in] form."""
        lead = self.start.shape
        out = np.zeros(lead + (n_in,), np.float32)
        cols = self.start[..., None] + np.arange(self.k)
        live = np.arange(self.k) < self.length[..., None]
        idx = np.nonzero(live)
        out[idx[:-1] + (cols[idx],)] = self.weight[idx]
        return out


def band_form(op: np.ndarray) -> Band:
    """Band form of one [n_out, n_in] operator (or a stack of them), from
    its dense entries: each row's first to last nonzero column."""
    op = np.asarray(op, np.float32)
    nz = op != 0
    first = nz.argmax(-1)
    last = op.shape[-1] - 1 - nz[..., ::-1].argmax(-1)
    length = np.where(nz.any(-1), last - first + 1, 0)
    width = max(int(length.max(initial=0)), 1)
    cols = np.minimum(first[..., None] + np.arange(width), op.shape[-1] - 1)
    weight = np.take_along_axis(op, cols, -1)
    weight = np.where(np.arange(width) < length[..., None], weight, 0.0)
    return Band(first.astype(np.int32), length.astype(np.int32),
                weight.astype(np.float32))


def _stack_bands(bands: list[Band]) -> Band:
    width = max(b.k for b in bands)
    pad = [np.pad(b.weight, ((0, 0), (0, width - b.k))) for b in bands]
    return Band(np.stack([b.start for b in bands]),
                np.stack([b.length for b in bands]), np.stack(pad))


@dataclasses.dataclass(frozen=True)
class TransformPlan:
    """Operators for one (resolution, colorspace) group of the knob grid,
    batching every (artifact mode, blur width) pair of that group.

    The settings axis is artifact-major: setting ``a * len(blur_ks) + b``
    pairs artifact mode ``art_modes[a]`` with blur width ``blur_ks[b]``
    (``art_ids``/``blur_ids`` carry the per-setting values).  The dense
    operators are the plan; the band fields are derived from them at
    construction (settings with one blur width share one operator).
    """
    cs: int                    # CS_BGR / CS_GRAY / CS_YUV420
    scale: float
    blur_ks: tuple[int, ...]
    art_modes: tuple[int, ...]  # knob4 modes batched (0=off, 1=movers, 2=contours)
    in_h: int                  # camera frame height
    in_w: int
    packed_h: int              # post-colorspace height (h + h//2 for yuv420)
    out_h: int                 # payload height after resize
    out_w: int
    n_planes: int              # 3 for bgr, 1 otherwise
    ry: np.ndarray             # [out_h, packed_h]
    rx: np.ndarray             # [out_w, in_w]
    bys: np.ndarray            # [S, out_h, out_h]
    bxs: np.ndarray            # [S, out_w, out_w]
    art_ids: np.ndarray        # [S] i32, per-setting artifact mode
    blur_ids: np.ndarray       # [S] i32, per-setting blur width
    ry_band: Band = dataclasses.field(init=False, repr=False, compare=False)
    rx_band: Band = dataclasses.field(init=False, repr=False, compare=False)
    by_band: Band = dataclasses.field(init=False, repr=False, compare=False)
    bx_band: Band = dataclasses.field(init=False, repr=False, compare=False)
    operands: "GridOperands" = dataclasses.field(init=False, repr=False,
                                                 compare=False)

    def __post_init__(self):
        first = {}
        for s, k in enumerate(np.asarray(self.blur_ids).tolist()):
            first.setdefault(k, s)
        by = {k: band_form(self.bys[s]) for k, s in first.items()}
        bx = {k: band_form(self.bxs[s]) for k, s in first.items()}
        ids = np.asarray(self.blur_ids).tolist()
        object.__setattr__(self, "ry_band", band_form(self.ry))
        object.__setattr__(self, "rx_band", band_form(self.rx))
        object.__setattr__(self, "by_band", _stack_bands([by[k] for k in ids]))
        object.__setattr__(self, "bx_band", _stack_bands([bx[k] for k in ids]))
        object.__setattr__(self, "operands", _grid_operands(self))

    @property
    def n_settings(self) -> int:
        return len(self.blur_ks) * len(self.art_modes)

    @property
    def with_artifact(self) -> bool:
        return bool((self.art_ids != 0).any())

    @property
    def payload_bytes(self) -> int:
        return self.n_planes * self.out_h * self.out_w


def build_transform_plan(h: int, w: int, *, scale: float, cs: int,
                         blur_ks: tuple[int, ...],
                         art_modes: tuple[int, ...] = (0,)) -> TransformPlan:
    """Build the operator bundle for one (resolution, colorspace) group.

    Requires even ``h``/``w`` for yuv420 (4:2:0 subsampling); the host
    NumPy path stays the oracle for odd geometries.
    """
    if cs == CS_YUV420 and (h % 2 or w % 2):
        raise ValueError(f"yuv420 grid transform needs even dims, got {h}x{w}")
    packed_h = h + h // 2 if cs == CS_YUV420 else h
    ry = resize_operator(packed_h, max(1, int(round(packed_h * scale))), scale)
    rx = resize_operator(w, max(1, int(round(w * scale))), scale)
    out_h, out_w = ry.shape[0], rx.shape[0]
    by_of = {k: blur_operator(out_h, k) for k in blur_ks}
    bx_of = {k: blur_operator(out_w, k) for k in blur_ks}
    pairs = [(a, k) for a in art_modes for k in blur_ks]   # artifact-major
    bys = np.stack([by_of[k] for _, k in pairs])
    bxs = np.stack([bx_of[k] for _, k in pairs])
    art_ids = np.asarray([a for a, _ in pairs], np.int32)
    blur_ids = np.asarray([k for _, k in pairs], np.int32)
    return TransformPlan(cs=cs, scale=scale, blur_ks=tuple(blur_ks),
                         art_modes=tuple(art_modes),
                         in_h=h, in_w=w, packed_h=packed_h,
                         out_h=out_h, out_w=out_w,
                         n_planes=3 if cs == CS_BGR else 1,
                         ry=ry, rx=rx, bys=bys, bxs=bxs,
                         art_ids=art_ids, blur_ids=blur_ids)


# =============================================================================
# The kernel's operands, derived once per plan
# =============================================================================

TILE_H, TILE_W = 32, 64          # csrc/frame_knob_grid.cu: TILE_H, TILE_W
UNIFORM_TAPS = (5, 8, 10, 15)    # csrc: the register-blocked tap counts


def _tile_spans(start: np.ndarray, end: np.ndarray, tile: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """[lo, hi) union of the bands ``[start, end)`` of every tile's computed
    outputs: its ``tile`` outputs and the next one (the features' extra row
    or column), ``[..., n_tiles]`` each."""
    n = start.shape[-1]
    cuts = [(t, min(t + tile + 1, n)) for t in range(0, n, tile)]
    lo = np.stack([start[..., a:b].min(-1) for a, b in cuts], -1)
    hi = np.stack([end[..., a:b].max(-1) for a, b in cuts], -1)
    return lo.astype(np.int32), hi.astype(np.int32)


def _uniform_taps(band: Band, tile: int) -> tuple[np.ndarray, np.ndarray]:
    """Per (setting, tile): the tap count K when every computed output of
    the tile (``tile + 1`` of them, all inside the image) has a K-tap band of
    one weight starting one input after the previous output's, with K among
    ``UNIFORM_TAPS``; else 0 (the kernel's general path).  And that weight."""
    n_set, n = band.start.shape
    n_tiles = -(-n // tile)
    taps = np.zeros((n_set, n_tiles), np.int32)
    weight = np.zeros((n_set, n_tiles), np.float32)
    for t in range(n_tiles):
        a, b = t * tile, t * tile + tile + 1
        if b > n:
            continue
        k, w = band.length[:, a], band.weight[:, a, 0]
        live = np.arange(band.k) < k[:, None, None]
        ok = (np.isin(k, UNIFORM_TAPS)
              & (band.length[:, a:b] == k[:, None]).all(-1)
              & (np.diff(band.start[:, a:b], axis=-1) == 1).all(-1)
              & ((band.weight[:, a:b] == w[:, None, None]) | ~live).all((1, 2)))
        taps[:, t] = np.where(ok, k, 0)
        weight[:, t] = np.where(ok, w, 0.0)
    return taps, weight


def _is_identity(band: Band) -> np.ndarray:
    """Per setting: every output reads its own input with weight 1."""
    n = band.start.shape[-1]
    return ((band.length == 1).all(-1) & (band.weight[..., 0] == 1.0).all(-1)
            & (band.start == np.arange(n)).all(-1))


def _unit_band(band: Band) -> bool:
    """Every output's weights are non-negative and sum to 1 within 1e-4, so
    a constant input gives the same constant out of the kernel's passes."""
    w = band.weight.astype(np.float64)
    return bool((w >= 0).all() and (np.abs(w.sum(-1) - 1.0) <= 1e-4).all())


@dataclasses.dataclass(frozen=True, eq=False)
class GridOperands:
    """Every operand of the CUDA grid kernel that depends on the plan alone,
    derived once per plan (``TransformPlan.operands``) and packed into one
    byte buffer (``host``: each array at a 16-byte-aligned offset of
    ``offsets``), which the wrapper uploads once per device.

    Tiles are ``TILE_H x TILE_W`` outputs, computed with one more row and
    column for the features.  ``arrays`` holds, besides the plan's bands
    and the artifact blocks: ``win_y``/``win_x`` ``[tiles, 2]``, the blur
    window of each tile (the resized rows and columns its blur settings
    read, staged once); ``col_span`` ``[S, tiles_x, 2]``, the columns the
    vertical pass computes for each setting; ``vk``/``vw`` and ``hk``/``hw``
    ``[S, tiles]``, the tap count and weight of the register-blocked pass,
    or 0 for the general one; ``ident`` ``[S]``, blur bands that are the
    identity; ``src_y``/``src_x`` ``[tiles, 2]``, the resize windows: the
    packed source rows and columns each tile's blur window reads (where
    knob4 keeps none of them, the kernel skips the tile's staging and
    passes: its payload is zeros)."""
    tiles_y: int
    tiles_x: int
    n_blocks: int
    n_per_block: int
    blocks_alike: bool               # same blur settings in every block
    unit_bands: bool                 # weights >= 0 summing to 1 within 1e-4
    win_h: int                       # staged window capacity (rows)
    win_w: int                       # (columns)
    arrays: dict
    host: np.ndarray                 # uint8, every array packed
    offsets: dict
    _device: dict = dataclasses.field(default_factory=dict, repr=False)

    def device_buffer(self, dev: torch.device) -> torch.Tensor | None:
        """The packed operands on ``dev``, once a call has uploaded them."""
        got = self._device.get(dev)
        return None if got is None else got.buffer


@dataclasses.dataclass(frozen=True)
class _DeviceOperands:
    buffer: torch.Tensor             # the packed operands on the card
    pinned: torch.Tensor             # its host staging copy
    args: "_FkgArgs"                 # kernel arguments with the plan's part


def _grid_operands(plan: "TransformPlan") -> GridOperands:
    """Derive the CUDA kernel's per-plan operands (``GridOperands``)."""
    modes, blocks = _art_blocks(plan)
    block_sets = [np.flatnonzero(blocks == a) for a in range(len(modes))]
    if len({len(b) for b in block_sets}) != 1:
        raise ValueError("frame_knob_grid: artifact blocks of unequal size")
    block_sets = np.stack(block_sets).astype(np.int32)
    by, bx, ry, rx = plan.by_band, plan.bx_band, plan.ry_band, plan.rx_band
    by_lo, by_hi = _tile_spans(by.start, by.start + by.length, TILE_H)
    bx_lo, bx_hi = _tile_spans(bx.start, bx.start + bx.length, TILE_W)
    win_y = np.stack([by_lo.min(0), by_hi.max(0)], -1)
    win_x = np.stack([bx_lo.min(0), bx_hi.max(0)], -1)
    ry_end, rx_end = ry.start + ry.length, rx.start + rx.length
    src_y = np.stack([[ry.start[a:b].min(), ry_end[a:b].max()]
                      for a, b in win_y]).astype(np.int32)
    src_x = np.stack([[rx.start[a:b].min(), rx_end[a:b].max()]
                      for a, b in win_x]).astype(np.int32)
    if (win_y.min() < 0 or win_y.max() > plan.out_h or win_x.min() < 0
            or win_x.max() > plan.out_w or src_y.min() < 0
            or src_y.max() > plan.packed_h or src_x.min() < 0
            or src_x.max() > plan.in_w):
        raise ValueError("frame_knob_grid: a band reads outside its input")
    vk, vw = _uniform_taps(by, TILE_H)
    hk, hw = _uniform_taps(bx, TILE_W)
    arrays = {
        "block_mode": np.asarray(modes, np.int32), "block_sets": block_sets,
        "ry_start": ry.start, "ry_w": ry.weight,
        "rx_start": rx.start, "rx_w": rx.weight,
        "by_start": by.start, "by_len": by.length, "by_w": by.weight,
        "bx_start": bx.start, "bx_len": bx.length, "bx_w": bx.weight,
        "win_y": win_y, "win_x": win_x, "src_y": src_y, "src_x": src_x,
        "col_span": np.stack([bx_lo, bx_hi], -1),
        "vk": vk, "vw": vw, "hk": hk, "hw": hw,
        "ident": (_is_identity(by) & _is_identity(bx)).astype(np.int32),
        "log2_table": np.log2(1.0 + np.arange(256, dtype=np.float32)),
    }
    parts, offsets, off = [], {}, 0
    for name, a in arrays.items():
        dtype = np.float32 if a.dtype.kind == "f" else np.int32
        raw = np.ascontiguousarray(a, dtype).reshape(-1).view(np.uint8)
        pad = -raw.size % 16
        parts += [raw, np.zeros(pad, np.uint8)]
        offsets[name] = off
        off += raw.size + pad
    return GridOperands(
        tiles_y=win_y.shape[0], tiles_x=win_x.shape[0],
        n_blocks=len(modes), n_per_block=block_sets.shape[1],
        blocks_alike=bool((plan.blur_ids[block_sets]
                           == plan.blur_ids[block_sets[:1]]).all()),
        unit_bands=all(_unit_band(b) for b in (ry, rx, by, bx)),
        win_h=int((win_y[:, 1] - win_y[:, 0]).max()),
        win_w=int((win_x[:, 1] - win_x[:, 0]).max()),
        arrays=arrays, host=np.concatenate(parts), offsets=offsets)


def proxy_features_host(payload: np.ndarray) -> np.ndarray:
    """NumPy version of ``proxy_features`` for one host payload (any shape
    with at least 2 dims; a 2-D payload is treated as one plane).  Used by
    ``CamBroker.fetch``'s per-frame candidate pre-screen."""
    a = np.asarray(payload).astype(np.int64)
    if a.ndim == 2:
        a = a[None]                      # packed/gray -> one plane
    else:
        a = np.moveaxis(a, -1, 0)        # interleaved HxWxC -> planes
    dx = np.abs(a[:, :, 1:] - a[:, :, :-1]).astype(np.float32)
    dy = np.abs(a[:, 1:, :] - a[:, :-1, :]).astype(np.float32)
    return np.asarray([
        np.log2(1.0 + dx).sum(), float((dx == 0).sum()),
        float((dx <= 2).sum()),
        np.log2(1.0 + dy).sum(), float((dy == 0).sum()),
        float((dy <= 2).sum()),
    ], np.float32)


# =============================================================================
# Plain PyTorch version
# =============================================================================


def proxy_features(payload: torch.Tensor) -> torch.Tensor:
    """Wire-size proxy features of a ``[..., P, oh, ow]`` uint8 payload
    batch, reduced over the last three axes: ``[..., 6]`` f32."""
    a = payload.to(torch.int32)
    dx = (a[..., :, 1:] - a[..., :, :-1]).abs().to(torch.float32)
    dy = (a[..., 1:, :] - a[..., :-1, :]).abs().to(torch.float32)
    dims = (-3, -2, -1)
    return torch.stack([
        torch.log2(1.0 + dx).sum(dims), (dx == 0).sum(dims).float(),
        (dx <= 2).sum(dims).float(),
        torch.log2(1.0 + dy).sum(dims), (dy == 0).sum(dims).float(),
        (dy <= 2).sum(dims).float(),
    ], dim=-1)


def _channel_mean_absdiff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Channel mean of ``|a - b|`` over the trailing BGR axis, in f32 (the
    integer sum divided once by 3)."""
    return (a.to(torch.float32) - b.to(torch.float32)).abs().sum(-1) / 3.0


def _artifact_masks(frames: torch.Tensor, bg: torch.Tensor, *,
                    thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """knob4 keep-masks (movers, contours) of uint8 ``[F, H, W, 3]`` frames
    against the raw background: channel-mean abs diff > thresh, cross
    dilation (false borders), contours = dilated minus its cross erosion
    (true borders)."""
    mask = _channel_mean_absdiff(frames, bg[None]) > thresh
    m = mask.clone()
    m[:, 1:, :] |= mask[:, :-1, :]
    m[:, :-1, :] |= mask[:, 1:, :]
    m[:, :, 1:] |= mask[:, :, :-1]
    m[:, :, :-1] |= mask[:, :, 1:]
    er = m.clone()
    er[:, 1:, :] &= m[:, :-1, :]
    er[:, :-1, :] &= m[:, 1:, :]
    er[:, :, 1:] &= m[:, :, :-1]
    er[:, :, :-1] &= m[:, :, 1:]
    return m, m & ~er


def _to_planes(frames: torch.Tensor, cs: int) -> torch.Tensor:
    """uint8 ``[F, H, W, 3]`` -> f32 planes ``[F, P, packed_h, W]``."""
    f = frames.to(torch.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    if cs == CS_BGR:
        return torch.stack([b, g, r], dim=1)
    y = 0.114 * b + 0.587 * g + 0.299 * r
    if cs == CS_GRAY:
        return y.round().clamp(0, 255)[:, None]
    u = 0.492 * (b - y) + 128.0
    v = 0.877 * (r - y) + 128.0
    y8 = y.round().clamp(0, 255)
    u8 = u[:, ::2, ::2].round().clamp(0, 255)
    v8 = v[:, ::2, ::2].round().clamp(0, 255)
    return torch.cat([y8, torch.cat([u8, v8], dim=2)], dim=1)[:, None]


def _art_blocks(plan: TransformPlan) -> tuple[list[int], np.ndarray]:
    """Distinct knob4 modes of the plan in setting order, and the block
    index of every setting."""
    modes = list(dict.fromkeys(np.asarray(plan.art_ids).tolist()))
    blocks = np.asarray([modes.index(m) for m in plan.art_ids.tolist()],
                        np.int32)
    return modes, blocks


def _check_inputs(frames, prev, plan, background, art_enable) -> None:
    """Shape/type/device checks shared by the kernel and its plain version
    (``RuntimeError``: a caller that swallows ``ValueError`` must not hide a
    broken call behind stale results)."""
    n = frames.shape[0]
    want = (n, plan.in_h, plan.in_w, 3)
    if tuple(frames.shape) != want or tuple(prev.shape) != want:
        raise RuntimeError(f"frame_knob_grid: frames/prev must be {want}, got "
                           f"{tuple(frames.shape)} / {tuple(prev.shape)}")
    tensors = [frames, prev]
    if background is not None:
        if tuple(background.shape) != want[1:]:
            raise RuntimeError(f"frame_knob_grid: background must be "
                               f"{want[1:]}, got {tuple(background.shape)}")
        tensors.append(background)
    elif plan.with_artifact:
        raise RuntimeError("frame_knob_grid: plan batches knob4 settings; "
                           "pass background=")
    if any(t.dtype != torch.uint8 for t in tensors):
        raise RuntimeError("frame_knob_grid: frames/prev/background must be "
                           "uint8")
    if art_enable is not None:
        if tuple(art_enable.shape) != (n,):
            raise RuntimeError(f"frame_knob_grid: art_enable must be ({n},), "
                               f"got {tuple(art_enable.shape)}")
        tensors.append(art_enable)
    if any(t.device != frames.device for t in tensors):
        raise RuntimeError("frame_knob_grid: every input must lie on one "
                           "device")


def frame_knob_grid_plain(frames: torch.Tensor, prev: torch.Tensor,
                          plan: TransformPlan, *,
                          background: torch.Tensor | None = None,
                          art_enable: torch.Tensor | None = None,
                          pixel_delta: float = 8.0,
                          art_thresh: float = ARTIFACT_THRESH
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``frame_knob_grid``: the reference's stages
    as tensor ops on whatever device the inputs lie on, with the resize and
    blur applied as dense einsums over the plan's operators, batched over
    the frames and looped over the settings.  Same inputs and outputs as
    ``frame_knob_grid``."""
    _check_inputs(frames, prev, plan, background, art_enable)
    dev = frames.device
    n = frames.shape[0]
    s_n = plan.n_settings
    # knob5 on the raw frame, before knob4: integer count / pixel count
    d = _channel_mean_absdiff(frames, prev)
    changed = ((d > pixel_delta).sum((1, 2)).to(torch.float32)
               / float(plan.in_h * plan.in_w))

    f32 = dict(dtype=torch.float32, device=dev)
    ry = torch.as_tensor(plan.ry, **f32)
    rx = torch.as_tensor(plan.rx, **f32)
    modes, blocks = _art_blocks(plan)
    if background is not None:
        movers, contours = _artifact_masks(frames, background,
                                           thresh=art_thresh)
        enable = (torch.ones(n, dtype=torch.int32, device=dev)
                  if art_enable is None else art_enable.to(torch.int32))
    resized = []
    for mode in modes:
        src = frames
        if background is not None and mode != 0:
            eff = (mode * enable)[:, None, None]
            keep = torch.where(eff == 1, movers,
                               torch.where(eff == 2, contours, True))
            src = torch.where(keep[..., None], frames, 0)
        planes = _to_planes(src, plan.cs)                          # [F,P,Hc,W]
        rs = torch.einsum("ah,fphw->fpaw", ry, planes)             # knob1
        rs = torch.einsum("bw,fpaw->fpab", rx, rs)
        resized.append(rs.round().clamp(0, 255))
    payload = torch.empty((s_n, n, plan.n_planes, plan.out_h, plan.out_w),
                          dtype=torch.uint8, device=dev)
    feats = torch.empty((s_n, n, N_PROXY_FEATURES), **f32)
    for s in range(s_n):
        by = torch.as_tensor(plan.bys[s], **f32)
        bx = torch.as_tensor(plan.bxs[s], **f32)
        bl = torch.einsum("ab,fpbw->fpaw", by, resized[blocks[s]])  # knob3
        bl = torch.einsum("cw,fpaw->fpac", bx, bl)
        payload[s] = bl.round().clamp(0, 255).to(torch.uint8)
        feats[s] = proxy_features(payload[s])
    return payload, feats, changed[None].expand(s_n, n).contiguous()


# =============================================================================
# The CUDA kernel
# =============================================================================


class _FkgArgs(ctypes.Structure):
    """Mirror of ``struct FkgArgs`` in ``csrc/frame_knob_grid.cu``."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            # per call
            "frames", "prev", "bg", "art_enable", "keep", "plane",
            "changed_count", "part_log", "part_cnt", "payload", "feats",
            "changed",
            # per plan: GridOperands.arrays on the card
            "block_mode", "block_sets", "ry_start", "ry_w", "rx_start",
            "rx_w", "by_start", "by_len", "by_w",
            "bx_start", "bx_len", "bx_w", "win_y", "win_x", "src_y", "src_x",
            "col_span", "vk", "vw", "hk", "hw", "ident", "log2_table")]
        + [(name, ctypes.c_int32) for name in (
            "F", "H", "W", "cs", "oh", "ow", "P", "S", "A", "n_per_block",
            "ry_k", "rx_k", "by_k", "bx_k", "tiles_y", "tiles_x", "win_h",
            "win_w", "blocks_alike", "unit_bands", "delta_min", "art_min")]
        + [("pixel_delta", ctypes.c_float), ("art_thresh", ctypes.c_float)])


_SMEM_LIMIT = 232448     # bytes of shared memory one block may use (H100)


def _load_lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_library
    lib = load_library("frame_knob_grid")
    lib.fkg_launch.argtypes = [ctypes.POINTER(_FkgArgs), ctypes.c_void_p]
    lib.fkg_launch.restype = ctypes.c_int
    lib.fkg_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.fkg_smem_bytes.restype = ctypes.c_int
    lib.fkg_error_string.argtypes = [ctypes.c_int]
    lib.fkg_error_string.restype = ctypes.c_char_p
    return lib


def _plan_on_device(lib: ctypes.CDLL, plan: TransformPlan,
                    dev: torch.device) -> _DeviceOperands:
    """The plan's operands on ``dev`` and the kernel arguments that depend
    on the plan alone: at the plan's first call on ``dev``, one upload from
    a pinned staging copy (kept with the buffer, so the non-blocking copy
    never reads freed memory); later calls find them cached."""
    ops = plan.operands
    got = ops._device.get(dev)
    if got is not None:
        return got
    if plan.in_h * plan.in_w >= 2 ** 31:
        raise RuntimeError("frame_knob_grid: frames above 2^31 pixels")
    if max(plan.ry_band.k, plan.rx_band.k) > 2:
        raise RuntimeError("frame_knob_grid: the kernel takes resize bands of "
                           "at most 2 taps")
    if lib.fkg_smem_bytes(plan.n_planes, ops.win_h, ops.win_w,
                          ops.n_per_block) > _SMEM_LIMIT:
        raise RuntimeError(f"frame_knob_grid: blur window {ops.win_h}x"
                           f"{ops.win_w} exceeds the shared memory of one "
                           f"block")
    pinned = torch.from_numpy(ops.host).pin_memory()
    buf = pinned.to(dev, non_blocking=True)
    base = buf.data_ptr()
    args = _FkgArgs(
        **{name: base + off for name, off in ops.offsets.items()},
        H=plan.in_h, W=plan.in_w, cs=plan.cs, oh=plan.out_h, ow=plan.out_w,
        P=plan.n_planes, S=plan.n_settings, A=ops.n_blocks,
        n_per_block=ops.n_per_block, ry_k=plan.ry_band.k,
        rx_k=plan.rx_band.k, by_k=plan.by_band.k, bx_k=plan.bx_band.k,
        tiles_y=ops.tiles_y, tiles_x=ops.tiles_x, win_h=ops.win_h,
        win_w=ops.win_w, blocks_alike=ops.blocks_alike,
        unit_bands=ops.unit_bands)
    got = ops._device[dev] = _DeviceOperands(buf, pinned, args)
    return got


def _launch(frames, prev, plan, background, art_enable, pixel_delta,
            art_thresh):
    if not all(t.is_contiguous() for t in (frames, prev)) or (
            background is not None and not background.is_contiguous()):
        raise RuntimeError("frame_knob_grid: inputs must be contiguous")
    lib = _load_lib()
    dev = frames.device
    on_dev = _plan_on_device(lib, plan, dev)
    n = frames.shape[0]
    s_n, p_n = plan.n_settings, plan.n_planes
    oh, ow = plan.out_h, plan.out_w
    n_tiles = plan.operands.tiles_y * plan.operands.tiles_x
    with_art = background is not None
    if with_art and art_enable is not None:
        art_enable = art_enable.to(torch.int32).contiguous()
    # one scratch buffer: keep codes, the gray / YUV plane, feature
    # partials, change counts
    n_keep = -(-n * plan.in_h * plan.in_w // 16) * 16 if with_art else 0
    n_plane = -(-n * plan.packed_h * plan.in_w // 16) * 16 if p_n == 1 else 0
    n_part = s_n * n * n_tiles
    scratch = torch.empty(n_keep + n_plane + 24 * n_part + 4 * n,
                          dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    payload = torch.empty((s_n, n, p_n, oh, ow), dtype=torch.uint8,
                          device=dev)
    feats = torch.empty((s_n, n, N_PROXY_FEATURES), dtype=torch.float32,
                        device=dev)
    changed = torch.empty((s_n, n), dtype=torch.float32, device=dev)
    args = _FkgArgs.from_buffer_copy(on_dev.args)
    args.frames, args.prev = frames.data_ptr(), prev.data_ptr()
    args.bg = background.data_ptr() if with_art else None
    args.art_enable = (art_enable.data_ptr()
                       if with_art and art_enable is not None else None)
    args.keep = base if with_art else None
    args.plane = base + n_keep if p_n == 1 else None
    args.part_log = base + n_keep + n_plane
    args.part_cnt = args.part_log + 8 * n_part
    args.changed_count = args.part_log + 24 * n_part
    args.payload, args.feats = payload.data_ptr(), feats.data_ptr()
    args.changed = changed.data_ptr()
    args.F = n
    args.pixel_delta, args.art_thresh = pixel_delta, art_thresh
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fkg_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"frame_knob_grid: CUDA error {rc}: "
                           f"{lib.fkg_error_string(rc).decode()}")
    frame_knob_grid.launches += 1
    return payload, feats, changed


def frame_knob_grid(frames: torch.Tensor, prev: torch.Tensor,
                    plan: TransformPlan, *,
                    background: torch.Tensor | None = None,
                    art_enable: torch.Tensor | None = None,
                    pixel_delta: float = 8.0,
                    art_thresh: float = ARTIFACT_THRESH,
                    device: "str | torch.device | None" = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Evaluate one plan's settings batch over a clip.

    frames/prev: uint8 ``[F, H, W, 3]`` (prev = the clip shifted by one for
    the knob5 metric).  Plans with knob4 settings also need ``background``
    (uint8 ``[H, W, 3]``) and may pass ``art_enable`` (i32 ``[F]``, default
    all-on) to exempt frames.  Returns

      payload [S, F, P, out_h, out_w] uint8   the shipped representation,
      feats   [S, F, 6] f32                   wire-size proxy features,
      changed [S, F] f32                      knob5 changed-pixel fraction
                                              (the same in every row).

    ``device`` (default ``"cuda"``) is where the call runs, and the inputs
    must lie there.  On CUDA it launches the hand-written kernel (and adds
    one to ``frame_knob_grid.launches``); on the CPU it takes
    ``frame_knob_grid_plain``.  Anything else raises ``RuntimeError``.
    """
    dev = resolve_device(device)
    if frames.device != dev and not (
            dev.type == "cuda" and dev.index is None
            and frames.device.type == "cuda"):
        raise RuntimeError(f"frame_knob_grid: inputs lie on {frames.device}, "
                           f"the call runs on {dev}")
    if dev.type == "cpu":
        return frame_knob_grid_plain(
            frames, prev, plan, background=background, art_enable=art_enable,
            pixel_delta=pixel_delta, art_thresh=art_thresh)
    if dev.type != "cuda":
        raise RuntimeError(f"frame_knob_grid: no kernel for device {dev}")
    _check_inputs(frames, prev, plan, background, art_enable)
    return _launch(frames, prev, plan, background, art_enable, pixel_delta,
                   art_thresh)


frame_knob_grid.launches = 0


# =============================================================================
# The fixed-function kernel of the camera node
# =============================================================================

KNOBS_KERNEL_DTYPES = {torch.uint8: 0, torch.float32: 1}


def _check_knobs(frames: torch.Tensor, prev: torch.Tensor,
                 blur_k: int) -> None:
    if frames.dim() != 3 or prev.shape != frames.shape:
        raise ValueError(f"frame_knobs: frames and prev [N, H, W] of one "
                         f"shape expected, got {tuple(frames.shape)}, "
                         f"{tuple(prev.shape)}")
    _, h, w = frames.shape
    if h % 2 or w % 2 or h < 2 or w < 2:
        raise ValueError(f"frame_knobs: H and W must be even, got {(h, w)}")
    if blur_k < 0:
        raise ValueError(f"frame_knobs: blur_k >= 0 expected, got {blur_k}")


def _knobs_scalars(h: int, w: int, blur_k: int, pixel_delta: float
                   ) -> tuple[float, float, float]:
    """The float32 operands both routes use: ``1/(h*w)``, ``1/k`` and the
    threshold, each rounded to float32 once (a reciprocal multiply, never a
    division: PyTorch on CUDA turns a division by a host scalar into one,
    so a division would round differently on the two devices)."""
    one = np.float32(1.0)
    return (float(one / np.float32(h * w)),
            float(one / np.float32(max(blur_k, 1))),
            float(np.float32(pixel_delta)))


def frame_knobs_plain(frames: torch.Tensor, prev: torch.Tensor, *,
                      blur_k: int = 5, pixel_delta: float = 8.0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``frame_knobs``, op for op the JAX body
    ``_knobs_kernel`` with its arithmetic fixed so the kernel can follow it
    exactly: the changed count is an integer sum of ``|f - prev| >
    pixel_delta`` times the float32 reciprocal of ``h*w``; the 2x2 sum is
    ``((f00 + f01) + f10) + f11`` times 0.25; the k vertical taps
    (``dy`` in ``[-(k//2), k - k//2)``, rows clamped at the edges) are added
    in ascending ``dy`` and multiplied by the float32 reciprocal of k, then
    the same horizontally.  ``blur_k <= 1`` means no blur."""
    _check_knobs(frames, prev, blur_k)
    f = frames.float()
    p = prev.float()
    n, h, w = f.shape
    inv_hw, inv_k, delta = _knobs_scalars(h, w, blur_k, pixel_delta)
    changed = ((f - p).abs() > delta).sum((1, 2)).to(torch.float32) * inv_hw

    q = f.reshape(n, h // 2, 2, w // 2, 2)
    out = (((q[:, :, 0, :, 0] + q[:, :, 0, :, 1]) + q[:, :, 1, :, 0])
           + q[:, :, 1, :, 1]) * 0.25
    if blur_k > 1:
        pad = blur_k // 2
        for dim in (1, 2):
            size = out.shape[dim]
            pos = torch.arange(size, device=f.device)
            acc = None
            for d in range(-pad, blur_k - pad):
                tap = out.index_select(dim, torch.clamp(pos + d, 0, size - 1))
                acc = tap if acc is None else acc + tap
            out = acc * inv_k
    return out, changed


def _load_knobs_lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_library
    lib = load_library("frame_knobs")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fk_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                              f32, f32, f32, i32, ptr]
    lib.fk_launch.restype = i32
    lib.fk_smem_bytes.argtypes = [i32]
    lib.fk_smem_bytes.restype = i32
    lib.fk_error_string.argtypes = [i32]
    lib.fk_error_string.restype = ctypes.c_char_p
    return lib


def _knobs_launch(frames: torch.Tensor, prev: torch.Tensor, blur_k: int,
                  pixel_delta: float) -> tuple[torch.Tensor, torch.Tensor]:
    if frames.device.type != "cuda" or prev.device != frames.device:
        raise RuntimeError(f"frame_knobs: frames and prev on one CUDA device "
                           f"(or both on the CPU) expected, got "
                           f"{frames.device}, {prev.device}")
    if frames.dtype != prev.dtype or frames.dtype not in KNOBS_KERNEL_DTYPES:
        raise RuntimeError(f"frame_knobs: the kernel takes uint8 or float32 "
                           f"frames and prev of one dtype, got "
                           f"{frames.dtype}, {prev.dtype}")
    if not (frames.is_contiguous() and prev.is_contiguous()):
        raise RuntimeError("frame_knobs: the kernel takes contiguous tensors")
    n, h, w = frames.shape
    if n > 65535 or h * w >= 2 ** 31:
        raise RuntimeError(f"frame_knobs: at most 65535 frames of under 2^31 "
                           f"pixels, got {tuple(frames.shape)}")
    lib = _load_knobs_lib()
    k = max(blur_k, 1)
    if lib.fk_smem_bytes(k) > _SMEM_LIMIT:
        raise RuntimeError(f"frame_knobs: blur_k {blur_k} exceeds the shared "
                           f"memory of one block")
    inv_hw, inv_k, delta = _knobs_scalars(h, w, blur_k, pixel_delta)
    out = torch.empty((n, h // 2, w // 2), dtype=torch.float32,
                      device=frames.device)
    changed = torch.empty(n, dtype=torch.float32, device=frames.device)
    count = torch.empty(n, dtype=torch.int32, device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = lib.fk_launch(frames.data_ptr(), prev.data_ptr(), out.data_ptr(),
                           changed.data_ptr(), count.data_ptr(), n, h, w, k,
                           inv_k, inv_hw, delta,
                           KNOBS_KERNEL_DTYPES[frames.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"frame_knobs: CUDA error {rc}: "
                           f"{lib.fk_error_string(rc).decode()}")
    frame_knobs.launches += 1
    return out, changed


def frame_knobs(frames: torch.Tensor, prev: torch.Tensor, *,
                blur_k: int = 5, pixel_delta: float = 8.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """frames/prev ``[N, H, W]`` (uint8 or float32, H and W even) ->
    (out float32 ``[N, H/2, W/2]``, changed float32 ``[N]``): the 2x2 mean
    pool, the edge-clamped ``blur_k``-tap box blur (none for ``blur_k <=
    1``) and the fraction of pixels with ``|f - prev| > pixel_delta``.

    On CUDA tensors it launches the hand-written kernel
    (``csrc/frame_knobs.cu``; uint8 or float32, both alike, contiguous)
    and adds one to ``frame_knobs.launches``; on CPU tensors it takes
    ``frame_knobs_plain``.  Anything else raises ``RuntimeError``; a shape
    the function does not take raises ``ValueError``."""
    _check_knobs(frames, prev, blur_k)
    if frames.device.type == "cpu" and prev.device.type == "cpu":
        return frame_knobs_plain(frames, prev, blur_k=blur_k,
                                 pixel_delta=pixel_delta)
    return _knobs_launch(frames, prev, blur_k, pixel_delta)


frame_knobs.launches = 0
