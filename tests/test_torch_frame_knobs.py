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
