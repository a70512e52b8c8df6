"""The knob grid as device compute: one pass over a clip evaluates every
setting of one (resolution, colorspace) group.

Per (setting, frame) it applies, in the order of the host pipeline:

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

Three pieces live here:

``build_transform_plan``     the host half: dense per-axis operators of one
                             group, plus their band form (start, length,
                             weights per output row) derived from them.
``frame_knob_grid_plain``    plain PyTorch ops that mirror the reference
                             stage for stage (dense einsums over the plan's
                             operators); the CPU path and the yardstick.
``frame_knob_grid``          the wrapper of the hand-written CUDA kernel
                             (``csrc/frame_knob_grid.cu``): on a CUDA device
                             it launches the kernel, on the CPU it takes the
                             plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["TransformPlan", "Band", "build_transform_plan", "band_form",
           "frame_knob_grid", "frame_knob_grid_plain", "resize_operator",
           "blur_operator", "proxy_features", "proxy_features_host",
           "N_PROXY_FEATURES", "ARTIFACT_THRESH", "CS_BGR", "CS_GRAY",
           "CS_YUV420"]

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
            "frames", "prev", "bg", "art_enable", "block_mode", "block_sets",
            "ry_start", "ry_len", "ry_w", "rx_start", "rx_len", "rx_w",
            "by_start", "by_len", "by_w", "bx_start", "bx_len", "bx_w",
            "ty_lo", "ty_hi", "tx_lo", "tx_hi", "log2_table", "mask_raw",
            "mask", "resized", "changed_count", "part_log", "part_cnt",
            "payload", "feats", "changed")]
        + [(name, ctypes.c_int32) for name in (
            "F", "H", "W", "cs", "packed_h", "oh", "ow", "P", "S", "A",
            "ry_k", "rx_k", "by_k", "bx_k", "feat_blocks", "win_y", "win_x",
            "tiles_y", "tiles_x", "n_per_block")]
        + [("pixel_delta", ctypes.c_float), ("art_thresh", ctypes.c_float)])


_BLUR_TILE = 32          # must match BLUR_TILE in the .cu source
_FEAT_BLOCKS = 64        # feature partials per (setting, frame)
_SMEM_LIMIT = 232448     # bytes of shared memory one block may use (H100)


def _tile_bounds(band: Band) -> tuple[np.ndarray, np.ndarray]:
    """Input window [lo, hi) of every BLUR_TILE-row tile of a band stack:
    the union of its rows' bands, ``[..., n_tiles]`` each."""
    start = band.start.astype(np.int64)
    end = start + band.length
    pad = [(0, 0)] * (start.ndim - 1) + [(0, -start.shape[-1] % _BLUR_TILE)]
    lo = np.pad(start, pad, mode="edge")
    hi = np.pad(end, pad, mode="edge")
    lo = lo.reshape(lo.shape[:-1] + (-1, _BLUR_TILE)).min(-1)
    hi = hi.reshape(hi.shape[:-1] + (-1, _BLUR_TILE)).max(-1)
    return lo.astype(np.int32), hi.astype(np.int32)


def _load_lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_library
    lib = load_library("frame_knob_grid")
    lib.fkg_launch.argtypes = [ctypes.POINTER(_FkgArgs), ctypes.c_void_p]
    lib.fkg_launch.restype = ctypes.c_int
    lib.fkg_error_string.argtypes = [ctypes.c_int]
    lib.fkg_error_string.restype = ctypes.c_char_p
    return lib


def _launch(frames, prev, plan, background, art_enable, pixel_delta,
            art_thresh):
    if not all(t.is_contiguous() for t in (frames, prev)) or (
            background is not None and not background.is_contiguous()):
        raise RuntimeError("frame_knob_grid: inputs must be contiguous")
    lib = _load_lib()
    dev = frames.device
    n = frames.shape[0]
    s_n, p_n = plan.n_settings, plan.n_planes
    oh, ow = plan.out_h, plan.out_w
    if plan.in_h * plan.in_w >= 2 ** 31:
        raise RuntimeError("frame_knob_grid: frames above 2^31 pixels")
    modes, blocks = _art_blocks(plan)
    # the blur walks each artifact block's settings over one input window
    block_sets = [np.flatnonzero(blocks == a) for a in range(len(modes))]
    if len({len(b) for b in block_sets}) != 1:
        raise RuntimeError("frame_knob_grid: artifact blocks of unequal size")
    block_sets = np.stack(block_sets).astype(np.int32)
    ty_lo, ty_hi = _tile_bounds(plan.by_band)
    tx_lo, tx_hi = _tile_bounds(plan.bx_band)
    ty_lo, tx_lo = (np.stack([lo[b].min(0) for b in block_sets])
                    for lo in (ty_lo, tx_lo))
    ty_hi, tx_hi = (np.stack([hi[b].max(0) for b in block_sets])
                    for hi in (ty_hi, tx_hi))
    win_y, win_x = int((ty_hi - ty_lo).max()), int((tx_hi - tx_lo).max())
    smem = 4 * ((win_y + _BLUR_TILE) * win_x + _BLUR_TILE * (
        plan.by_band.k + plan.bx_band.k) + 4 * _BLUR_TILE)
    if smem > _SMEM_LIMIT:
        raise RuntimeError(f"frame_knob_grid: blur window {win_y}x{win_x} "
                           f"exceeds the shared memory of one block")
    with_art = background is not None

    # the small operands travel in two host->device copies (one i32, one
    # f32 buffer); each field is a view into its buffer
    ints = [("block_mode", np.asarray(modes, np.int32)),
            ("block_sets", block_sets)]
    flts = [("log2_table", np.log2(1.0 + np.arange(256, dtype=np.float32)))]
    for tag, band in (("ry", plan.ry_band), ("rx", plan.rx_band),
                      ("by", plan.by_band), ("bx", plan.bx_band)):
        ints += [(f"{tag}_start", band.start), (f"{tag}_len", band.length)]
        flts.append((f"{tag}_w", band.weight))
    ints += [("ty_lo", ty_lo), ("ty_hi", ty_hi), ("tx_lo", tx_lo),
             ("tx_hi", tx_hi)]
    keep = {}                                    # alive until the launch
    for parts, dtype in ((ints, np.int32), (flts, np.float32)):
        buf = torch.from_numpy(np.concatenate(
            [np.ravel(a).astype(dtype) for _, a in parts])).to(dev)
        off = 0
        for name, a in parts:
            keep[name] = buf[off:off + a.size]
            off += a.size
    if with_art:
        keep["art_enable"] = (
            torch.ones(n, dtype=torch.int32, device=dev) if art_enable is None
            else art_enable.to(torch.int32).contiguous())
        keep["mask_raw"] = torch.empty((n, plan.in_h, plan.in_w),
                                       dtype=torch.uint8, device=dev)
        keep["mask"] = torch.empty_like(keep["mask_raw"])
    empty = dict(device=dev)
    keep["resized"] = torch.empty((len(modes), n, p_n, oh, ow),
                                  dtype=torch.uint8, **empty)
    keep["changed_count"] = torch.empty(n, dtype=torch.int32, **empty)
    keep["part_log"] = torch.empty((s_n * n, _FEAT_BLOCKS, 2),
                                   dtype=torch.float32, **empty)
    keep["part_cnt"] = torch.empty((s_n * n, _FEAT_BLOCKS, 4),
                                   dtype=torch.int32, **empty)
    payload = torch.empty((s_n, n, p_n, oh, ow), dtype=torch.uint8, **empty)
    feats = torch.empty((s_n, n, N_PROXY_FEATURES), dtype=torch.float32,
                        **empty)
    changed = torch.empty((s_n, n), dtype=torch.float32, **empty)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = _FkgArgs(
        frames=ptr(frames), prev=ptr(prev),
        bg=ptr(background) if with_art else None,
        payload=ptr(payload), feats=ptr(feats), changed=ptr(changed),
        **{k: ptr(v) for k, v in keep.items()},
        F=n, H=plan.in_h, W=plan.in_w, cs=plan.cs, packed_h=plan.packed_h,
        oh=oh, ow=ow, P=p_n, S=s_n, A=len(modes),
        ry_k=plan.ry_band.k, rx_k=plan.rx_band.k, by_k=plan.by_band.k,
        bx_k=plan.bx_band.k, feat_blocks=_FEAT_BLOCKS,
        win_y=win_y, win_x=win_x, tiles_y=ty_lo.shape[-1],
        tiles_x=tx_lo.shape[-1], n_per_block=block_sets.shape[1],
        pixel_delta=pixel_delta, art_thresh=art_thresh)
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
