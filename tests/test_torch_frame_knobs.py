"""The port's knob-grid module against the JAX package: transform plans,
their band form, and the plain PyTorch grid against
``repro.kernels.ref.frame_knob_grid_ref`` for every (resolution, colorspace)
group, with and without knob4 (with a partial per-frame knob4 enable).

Tolerances: payloads within one grey level on at most 1e-3 of the bytes
(the dense operator products sum in another order than XLA's, which can
flip an exact .5 before rounding); ``changed`` exactly equal; the proxy
features against the reference's within 1e-3 relative plus 2 per payload
byte that differs (each such byte moves at most two deltas per direction
by one grey level), and equal to the features of the payload the call
produced (counts exactly, log2 sums within 1e-3 relative).  Measured at
144x256: where no byte differs the log2 sums agree within 1e-5 relative
and the counts exactly; where bytes differ, a feature moved by at most
2.0 per differing byte, up to 9.4e-3 relative on the small sums of knob4
payloads.

The JAX package is imported only by the tests that compare against it, so
the ``cuda``-marked test also runs on a machine without JAX:
``python -m pytest -m cuda tests/test_torch_frame_knobs.py``.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import knobs as K  # noqa: E402
from repro_torch.data.camera import CameraConfig, SyntheticCamera  # noqa: E402
from repro_torch.kernels import frame_knobs as FK  # noqa: E402

H, W = 144, 256
GROUPS = [(res, cs) for res in range(len(K.RESOLUTION_SCALES))
          for cs in range(len(K.COLORSPACES))]
ARTS = [(0,), (0, 1, 2)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's grid kernel module and its oracle."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import frame_knobs, ref
    return types.SimpleNamespace(jnp=jnp, FK=frame_knobs, ref=ref)


def jax_plan(jx, res, cs, art):
    return jx.FK.build_transform_plan(H, W, scale=K.RESOLUTION_SCALES[res],
                                      cs=cs, blur_ks=K.BLUR_KERNELS,
                                      art_modes=art)


def plan_fields(plan):
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
            if f.init}


def check_grid(got, want, *, max_frac=1e-3):
    """Kernel-contract comparison of two (payload, feats, changed) triples
    (torch ``got``; NumPy or torch ``want``)."""
    pg, fg, cg = (t.cpu().numpy() for t in got)
    pw, fw, cw = (np.asarray(t.cpu() if hasattr(t, "cpu") else t)
                  for t in want)
    assert pg.shape == pw.shape and pg.dtype == np.uint8
    d = np.abs(pg.astype(np.int32) - pw.astype(np.int32))
    assert d.max() <= 1
    assert (d != 0).mean() <= max_frac
    np.testing.assert_array_equal(cg, cw)
    # features against the reference's: a byte off by one enters at most
    # two deltas per direction and moves each by one grey level, so each
    # feature may move by 2 per such byte (log2(2+x) - log2(1+x) <= 1);
    # beyond that, log2 sums within 1e-3 relative and counts exact
    assert fg.shape == fw.shape
    n_off = (d != 0).sum(axis=(-3, -2, -1))[..., None]
    lg, lw = fg[..., [0, 3]], fw[..., [0, 3]]
    assert (np.abs(lg - lw) <= 1e-3 * np.abs(lw) + 2 * n_off).all()
    assert (np.abs(fg[..., [1, 2, 4, 5]] - fw[..., [1, 2, 4, 5]])
            <= 2 * n_off).all()
    # and the features of the payload this call produced
    own = FK.proxy_features(got[0]).cpu().numpy()
    np.testing.assert_array_equal(fg[..., [1, 2, 4, 5]], own[..., [1, 2, 4, 5]])
    np.testing.assert_allclose(fg[..., [0, 3]], own[..., [0, 3]], rtol=1e-3)


@pytest.fixture(scope="module")
def clip():
    cam = SyntheticCamera(CameraConfig(dynamics="complex", seed=7))
    bg = cam.background
    frames = np.stack([bg] + [cam.next_frame()[1] for _ in range(2)])
    prev = np.concatenate([frames[:1], frames[:-1]])
    enable = np.asarray([0, 1, 1], np.int32)      # partial: frame 0 exempt
    return frames, prev, bg, enable


@pytest.mark.parametrize("art", ARTS, ids=["noart", "art"])
@pytest.mark.parametrize("res,cs", GROUPS)
def test_plan_matches_jax(jx, res, cs, art):
    jp = jax_plan(jx, res, cs, art)
    tp = FK.build_transform_plan(H, W, scale=K.RESOLUTION_SCALES[res],
                                 cs=cs, blur_ks=K.BLUR_KERNELS,
                                 art_modes=art)
    for name, want in plan_fields(jp).items():
        got = getattr(tp, name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got == want, name
    # the band form is the dense operators, entry for entry
    np.testing.assert_array_equal(tp.ry_band.dense(tp.packed_h), tp.ry)
    np.testing.assert_array_equal(tp.rx_band.dense(tp.in_w), tp.rx)
    np.testing.assert_array_equal(tp.by_band.dense(tp.out_h), tp.bys)
    np.testing.assert_array_equal(tp.bx_band.dense(tp.out_w), tp.bxs)
    assert tp.rx_band.k <= 2 and tp.bx_band.k <= max(K.BLUR_KERNELS)
    # a plan carried across from the JAX package derives the same bands
    conv = convert.plan_from_numpy(**plan_fields(jp))
    for tag in ("ry_band", "rx_band", "by_band", "bx_band"):
        a, b = getattr(conv, tag), getattr(tp, tag)
        for f in ("start", "length", "weight"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("art", ARTS, ids=["noart", "art"])
@pytest.mark.parametrize("res,cs", GROUPS)
def test_plain_matches_ref(jx, clip, res, cs, art):
    frames, prev, bg, enable = clip
    jnp = jx.jnp
    jp = jax_plan(jx, res, cs, art)
    tp = convert.plan_from_numpy(**plan_fields(jp))
    jkw, tkw = {}, {}
    if art != (0,):
        jkw = dict(background=jnp.asarray(bg), art_enable=jnp.asarray(enable))
        tkw = dict(background=torch.as_tensor(bg),
                   art_enable=torch.as_tensor(enable))
    want = jx.ref.frame_knob_grid_ref(jnp.asarray(frames),
                                      jnp.asarray(prev), jp, **jkw)
    got = FK.frame_knob_grid(torch.as_tensor(frames), torch.as_tensor(prev),
                             tp, device="cpu", **tkw)
    check_grid(got, want)
    # knob4 settings really differ from knob4-off where the mask bites
    if art != (0,):
        n_blur = len(K.BLUR_KERNELS)
        assert not torch.equal(got[0][n_blur:2 * n_blur, 1],
                               got[0][:n_blur, 1])
        # the exempt frame 0 carries the knob4-off payload in every block
        assert torch.equal(got[0][n_blur:2 * n_blur, 0], got[0][:n_blur, 0])


def test_band_form_of_random_bands():
    rng = np.random.default_rng(5)
    op = np.zeros((40, 60), np.float32)
    for i in range(40):
        s = rng.integers(0, 55)
        op[i, s:s + rng.integers(1, 6)] = rng.uniform(0.01, 1, 1)
    op[7] = 0.0                                   # an empty row
    band = FK.band_form(op)
    assert band.length[7] == 0
    np.testing.assert_array_equal(band.dense(60), op)


def test_wrapper_checks_inputs(clip):
    frames, prev, bg, _ = clip
    plan = FK.build_transform_plan(H, W, scale=0.5, cs=1, blur_ks=(0, 5),
                                   art_modes=(0, 1))
    f, p = torch.as_tensor(frames), torch.as_tensor(prev)
    with pytest.raises(RuntimeError, match="background"):
        FK.frame_knob_grid(f, p, plan, device="cpu")
    with pytest.raises(RuntimeError, match="uint8"):
        FK.frame_knob_grid(f.float(), p.float(), plan, device="cpu",
                           background=torch.as_tensor(bg))
    with pytest.raises(RuntimeError):
        FK.frame_knob_grid(f[:, :-2], p[:, :-2], plan, device="cpu",
                           background=torch.as_tensor(bg))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(clip):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames, prev, bg, enable = clip
    dev = torch.device("cuda")
    f, p = torch.as_tensor(frames).to(dev), torch.as_tensor(prev).to(dev)
    kw = dict(background=torch.as_tensor(bg).to(dev),
              art_enable=torch.as_tensor(enable).to(dev))
    before = FK.frame_knob_grid.launches
    for res, cs in GROUPS:
        plan = FK.build_transform_plan(H, W, scale=K.RESOLUTION_SCALES[res],
                                       cs=cs, blur_ks=K.BLUR_KERNELS,
                                       art_modes=(0, 1, 2))
        got = FK.frame_knob_grid(f, p, plan, **kw)
        want = FK.frame_knob_grid_plain(f, p, plan, **kw)
        check_grid(got, want)
    assert FK.frame_knob_grid.launches == before + len(GROUPS)


# -- the CUDA kernel's operands, derived once per plan -------------------------


def covers(lo, hi, start, length):
    """Every band ``[start, start + length)`` lies inside ``[lo, hi)``."""
    return bool(((start >= lo) & (start + length <= hi)).all())


@pytest.mark.parametrize("art", ARTS, ids=["noart", "art"])
@pytest.mark.parametrize("res,cs", GROUPS)
def test_grid_operands_windows(res, cs, art):
    plan = FK.build_transform_plan(H, W, scale=K.RESOLUTION_SCALES[res],
                                   cs=cs, blur_ks=K.BLUR_KERNELS,
                                   art_modes=art)
    ops = plan.operands
    assert plan.operands is ops                  # derived once, with the plan
    a = ops.arrays
    for axis, tile, n_out, blur, rsz, win, src, col_span, taps, wt in (
            ("y", FK.TILE_H, plan.out_h, plan.by_band, plan.ry_band,
             a["win_y"], a["src_y"], None, a["vk"], a["vw"]),
            ("x", FK.TILE_W, plan.out_w, plan.bx_band, plan.rx_band,
             a["win_x"], a["src_x"], a["col_span"], a["hk"], a["hw"])):
        assert win.shape == (-(-n_out // tile), 2), axis
        for t, (lo, hi) in enumerate(win):
            # the tile's outputs and the features' extra row / column
            rows = slice(t * tile, min(t * tile + tile + 1, n_out))
            assert covers(lo, hi, blur.start[:, rows], blur.length[:, rows])
            assert hi - lo <= (ops.win_h if axis == "y" else ops.win_w)
            # every staged sample's resize band inside the resize window
            assert covers(src[t, 0], src[t, 1], rsz.start[lo:hi],
                          rsz.length[lo:hi])
            if col_span is not None:     # the vertical pass's columns
                span = col_span[:, t]
                assert covers(span[:, :1], span[:, 1:], blur.start[:, rows],
                              blur.length[:, rows])
                assert (span[:, 0] >= lo).all() and (span[:, 1] <= hi).all()
            for s in range(plan.n_settings):
                k = taps[s, t]
                if k == 0:
                    continue
                # a register-blocked tile: tile + 1 outputs, K taps of one
                # weight, each band one input after the previous one
                assert k in FK.UNIFORM_TAPS and rows.stop - rows.start == tile + 1
                assert (blur.length[s, rows] == k).all()
                assert (np.diff(blur.start[s, rows]) == 1).all()
                assert (blur.weight[s, rows, :k] == wt[s, t]).all()
    # the identity settings are exactly blur width 0; every band of a built
    # plan sums to one (so the kernel may fill constant windows)
    np.testing.assert_array_equal(a["ident"], plan.blur_ids <= 1)
    assert ops.unit_bands and ops.blocks_alike
    np.testing.assert_array_equal(a["block_sets"].ravel(),
                                  np.arange(plan.n_settings))
    # one packed buffer: every array at its 16-byte-aligned offset
    for name, arr in a.items():
        off = ops.offsets[name]
        assert off % 16 == 0
        dtype = np.float32 if arr.dtype.kind == "f" else np.int32
        got = ops.host[off:off + arr.size * 4].view(dtype).reshape(arr.shape)
        np.testing.assert_array_equal(got, arr.astype(dtype), err_msg=name)


def test_grid_operands_mark_interior_tiles_at_1080p():
    """At the camera's size most tiles of a blurring setting take the
    register-blocked passes; the edge tiles and blur 0 never do."""
    plan = FK.build_transform_plan(1080, 1920, scale=1.0, cs=FK.CS_BGR,
                                   blur_ks=K.BLUR_KERNELS)
    a = plan.operands.arrays
    blurring = plan.blur_ids > 1
    assert (a["vk"][~blurring] == 0).all() and (a["hk"][~blurring] == 0).all()
    for taps in (a["vk"], a["hk"]):
        inner = taps[blurring][:, 1:-1]
        np.testing.assert_array_equal(inner, np.broadcast_to(
            plan.blur_ids[blurring][:, None], inner.shape))
    assert (a["vk"][:, [0, -1]] == 0).all() and (a["hk"][:, [0, -1]] == 0).all()
    assert plan.operands.win_h == FK.TILE_H + max(K.BLUR_KERNELS)
    assert plan.operands.win_w == FK.TILE_W + max(K.BLUR_KERNELS)


@pytest.mark.parametrize("art", ARTS, ids=["noart", "art"])
@pytest.mark.parametrize("res,cs", GROUPS)
def test_exact_reference_is_the_plain_arithmetic(clip, res, cs, art):
    """The card tests' bitwise oracle against the plain version on the CPU:
    within the kernel contract (measured here: every byte equal)."""
    frames, prev, bg, enable = clip
    plan = FK.build_transform_plan(H, W, scale=K.RESOLUTION_SCALES[res],
                                   cs=cs, blur_ks=K.BLUR_KERNELS,
                                   art_modes=art)
    kw, ref_kw = {}, {}
    if art != (0,):
        kw = dict(background=torch.as_tensor(bg),
                  art_enable=torch.as_tensor(enable))
        ref_kw = dict(bg=bg, enable=enable)
    got = FK.frame_knob_grid(torch.as_tensor(frames), torch.as_tensor(prev),
                             plan, device="cpu", **kw)
    payload, changed = exact_reference(frames, prev, plan, **ref_kw)
    check_grid(got, (payload, FK.proxy_features(torch.as_tensor(payload)),
                     np.broadcast_to(changed, got[2].shape)))


# -- the CUDA kernel on the card ------------------------------------------------


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def fma32(a, b, c):
    """float32 fmaf(a, b, c): the exact a * b (48 bits) plus c in float64,
    rounded once to float32.  Where a float64 sum would round (an exponent
    spread above 2^5), the result lies far from a float32 tie, so it rounds
    as fmaf does."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def band_pass(x, band, axis):
    """One band pass over ``axis`` of float32 ``x`` in the kernel's order:
    every output sums its taps in ascending order from 0 with fmaf; a tap
    past a band's length has weight 0 (``fmaf(0, v, acc) = acc``) and a
    clamped index."""
    x = np.moveaxis(x, axis, -1)
    n_in = x.shape[-1]
    acc = np.zeros(x.shape[:-1] + band.start.shape, np.float32)
    for t in range(band.k):
        idx = np.minimum(band.start + t, n_in - 1)
        acc = fma32(band.weight[:, t], x[..., idx], acc)
    return np.moveaxis(acc, -1, axis)


def round_clip(x):
    return np.clip(np.rint(x), 0, 255).astype(np.float32)


def exact_reference(frames, prev, plan, bg=None, enable=None,
                    pixel_delta=8.0):
    """The kernel's arithmetic contract in NumPy, independent of the plain
    version's dense products (whose summation order on the card changes
    with the shape): knob5 and knob4 as the plain version computes them,
    then the resize and blur band passes tap by tap with fmaf, each stage's
    round/clip.  Returns (payload uint8 [S, F, P, oh, ow], changed f32
    [F])."""
    ft, pt = torch.as_tensor(frames), torch.as_tensor(prev)
    n = len(frames)
    count = (FK._channel_mean_absdiff(ft, pt) > pixel_delta).sum((1, 2))
    changed = count.numpy().astype(np.float32) / np.float32(
        plan.in_h * plan.in_w)
    modes, blocks = FK._art_blocks(plan)
    if bg is not None:
        movers, contours = (m.numpy() for m in FK._artifact_masks(
            ft, torch.as_tensor(bg), thresh=FK.ARTIFACT_THRESH))
    resized = []
    for mode in modes:
        src = frames
        if bg is not None and mode != 0:
            eff = (mode * enable)[:, None, None]
            keep = np.where(eff == 1, movers, np.where(eff == 2, contours,
                                                       True))
            src = np.where(keep[..., None], frames, 0).astype(np.uint8)
        planes = FK._to_planes(torch.as_tensor(src), plan.cs).numpy()
        rs = band_pass(band_pass(planes, plan.ry_band, 2), plan.rx_band, 3)
        resized.append(round_clip(rs))
    payload = np.empty((plan.n_settings, n, plan.n_planes, plan.out_h,
                        plan.out_w), np.uint8)
    for s in range(plan.n_settings):
        by = FK.Band(plan.by_band.start[s], plan.by_band.length[s],
                     plan.by_band.weight[s])
        bx = FK.Band(plan.bx_band.start[s], plan.bx_band.length[s],
                     plan.bx_band.weight[s])
        bl = band_pass(band_pass(resized[blocks[s]], by, 2), bx, 3)
        payload[s] = round_clip(bl)
    return payload, changed


def check_exact(got, want):
    """The kernel against ``exact_reference``: payload and ``changed``
    bitwise; its features against those of its own payload, counts exactly
    and log2 sums within 1e-3 relative (their summation order differs)."""
    pg, fg, cg = (t.cpu() for t in got)
    pw, cw = want
    np.testing.assert_array_equal(pg.numpy(), pw)
    np.testing.assert_array_equal(cg.numpy(), np.broadcast_to(cw, cg.shape))
    own = FK.proxy_features(pg)
    assert torch.equal(fg[..., [1, 2, 4, 5]], own[..., [1, 2, 4, 5]])
    torch.testing.assert_close(fg[..., [0, 3]], own[..., [0, 3]], rtol=1e-3,
                               atol=0.0)


def camera_clip(h, w, n):
    """The background and ``n - 1`` frames of a complex ``h x w`` camera,
    prev shifted by one, knob4 off on frame 0."""
    cam = SyntheticCamera(CameraConfig(height=h, width=w, dynamics="complex",
                                       seed=7))
    frames = np.stack([cam.background]
                      + [cam.next_frame()[1] for _ in range(n - 1)])
    prev = np.concatenate([frames[:1], frames[:-1]])
    enable = np.ones(n, np.int32)
    enable[0] = 0
    return frames, prev, cam.background, enable


def run_groups(dev, h, w, n, art):
    """Every group: the kernel bitwise against ``exact_reference`` and
    against the plain version on the CPU (``check_grid``, which at these
    inputs finds every byte equal: ``test_exact_reference_is_the_plain_
    arithmetic``).  The plain version on the card is no bitwise oracle at
    these shapes: its dense products sum in another order there, and its
    ``changed`` divides through a reciprocal."""
    host = camera_clip(h, w, n)
    frames, prev, bg, enable = (torch.as_tensor(x).to(dev) for x in host)
    cpu = [torch.as_tensor(x) for x in host]
    kw = {} if art == (0,) else dict(background=bg, art_enable=enable)
    cpu_kw = {} if art == (0,) else dict(background=cpu[2],
                                         art_enable=cpu[3])
    ref_kw = {} if art == (0,) else dict(bg=host[2], enable=host[3])
    for res, cs in GROUPS:
        plan = FK.build_transform_plan(h, w, scale=K.RESOLUTION_SCALES[res],
                                       cs=cs, blur_ks=K.BLUR_KERNELS,
                                       art_modes=art)
        got = FK.frame_knob_grid(frames, prev, plan, **kw)
        check_exact(got, exact_reference(host[0], host[1], plan, **ref_kw))
        check_grid(got, FK.frame_knob_grid_plain(cpu[0], cpu[1], plan,
                                                 **cpu_kw), max_frac=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("art", ARTS, ids=["noart", "art"])
def test_cuda_kernel_bit_equal_to_reference(art):
    run_groups(cuda_or_skip(), H, W, 3, art)


@pytest.mark.cuda
@pytest.mark.parametrize("art", ARTS, ids=["noart", "art"])
def test_cuda_kernel_ragged_tiles(art):
    """146x262: ragged edge tiles on both axes at every scale, and payload
    rows that are no multiple of 16 bytes (the byte-store path)."""
    run_groups(cuda_or_skip(), 146, 262, 3, art)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 17])
def test_cuda_kernel_odd_frame_counts(n):
    run_groups(cuda_or_skip(), H, W, n, (0, 1, 2))


@pytest.mark.cuda
def test_cuda_kernel_repeatable_and_uploads_once():
    """Two calls on one plan: bit-identical outputs, and the second finds
    the plan's operands on the card (no new upload, no host->device copy:
    the buffer keeps its data_ptr)."""
    cuda_or_skip()
    frames, prev, bg, enable = (torch.as_tensor(x).cuda()
                                for x in camera_clip(H, W, 17))
    dev = frames.device
    plan = FK.build_transform_plan(H, W, scale=0.6833, cs=FK.CS_BGR,
                                   blur_ks=K.BLUR_KERNELS,
                                   art_modes=(0, 1, 2))
    assert plan.operands.device_buffer(dev) is None
    kw = dict(background=bg, art_enable=enable)
    first = FK.frame_knob_grid(frames, prev, plan, **kw)
    buf = plan.operands.device_buffer(dev)
    ptr = buf.data_ptr()
    second = FK.frame_knob_grid(frames, prev, plan, **kw)
    assert plan.operands.device_buffer(dev) is buf and buf.data_ptr() == ptr
    for a, b in zip(first, second):
        assert torch.equal(a, b)
