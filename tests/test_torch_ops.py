"""The port's public kernel entry points (``repro_torch.kernels.ops``) and
the camera node's knob kernel (``frame_knobs``) against the JAX package.

``frame_knobs_plain`` against the Pallas ``frame_knobs`` in interpret mode
(as ``tests/test_kernels.py::TestFrameKnobs`` runs it) and against the
oracle ``repro.kernels.ref.frame_knobs_ref``, on seeded NumPy frames in
uint8 and float32.  Tolerances:

- ``changed`` exactly: both count 0/1 values (exact in any order below
  2^24) and scale by the float32 reciprocal of ``h*w``, as XLA does for
  the JAX division by a constant.
- ``out`` within rtol 1e-5 and atol 1e-3, the JAX test's own tolerance
  between its kernel and its oracle.  The port fixes one order for the
  2x2 sum (``((f00 + f01) + f10) + f11``) and the taps (ascending); XLA's
  order for the pooled sum depends on the shape, so no single order
  matches it everywhere, and the two land 2-4 float32 ulps apart (up to
  ~8e-5 at values of 128-255) on some pixels.

The other five wrappers on CPU tensors: the quantize pair bit for bit
against ``ref.quantize_ref`` / ``dequantize_ref`` and against JAX's
``ops.quantize_blocks`` / ``ops.dequantize_blocks`` under
``tests/test_kernels.py::TestQuantize``'s tolerance (|dq| <= 1 on under 1%
of the values: the interpreted Pallas kernel divides through a
reciprocal); flash, decode and wkv against the ``ref`` oracles (their
Pallas kernels cannot run on this JAX, ROADMAP Queue 3): float32 within
2e-5 absolute for attention (summation order), wkv within 1e-4 of the
oracle's max |.| (the chunked plain scan takes each decay as ``exp`` of a
difference of cumulative sums).

The ``cuda``-marked test holds the kernel to its plain version bit for bit
on the card and imports no JAX:
``python -m pytest -m cuda tests/test_torch_ops.py``.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import frame_knobs as FK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


@pytest.fixture
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref
    from repro.kernels.frame_knobs import frame_knobs
    from repro.models.attention import repeat_kv
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    return types.SimpleNamespace(jnp=jnp, ops=jops, ref=ref,
                                 frame_knobs=frame_knobs, repeat_kv=repeat_kv)


def knob_frames(n, h, w, dtype, *, seed=22):
    """Frames and prev around grey 128 (sd 60), clipped to [0, 255]."""
    f = (np.random.default_rng(seed).normal(size=(n, h, w)) * 60 + 128)
    p = (np.random.default_rng(seed + 1).normal(size=(n, h, w)) * 60 + 128)
    return f.clip(0, 255).astype(dtype), p.clip(0, 255).astype(dtype)


KNOB_CASES = [(64, 128, 5), (48, 96, 3), (64, 128, 1), (64, 128, 8),
              (64, 128, 10), (136, 240, 15)]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["uint8", "float32"])
@pytest.mark.parametrize("h,w,blur", KNOB_CASES,
                         ids=[f"{h}x{w}-k{k}" for h, w, k in KNOB_CASES])
def test_frame_knobs_plain_matches_pallas_and_ref(jx, h, w, blur, dtype):
    f, p = knob_frames(3, h, w, dtype)
    out, ch = FK.frame_knobs_plain(torch.from_numpy(f), torch.from_numpy(p),
                                   blur_k=blur)
    assert out.shape == (3, h // 2, w // 2) and out.dtype == torch.float32
    assert ch.shape == (3,) and ch.dtype == torch.float32
    for want_out, want_ch in (
            jx.frame_knobs(jx.jnp.asarray(f), jx.jnp.asarray(p), blur_k=blur,
                           interpret=True),
            jx.ref.frame_knobs_ref(jx.jnp.asarray(f), jx.jnp.asarray(p),
                                   blur_k=blur)):
        np.testing.assert_array_equal(ch.numpy(), np.asarray(want_ch))
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   rtol=1e-5, atol=1e-3)


def test_change_metric_detects_motion():
    base = torch.full((1, 32, 64), 100.0)
    moved = base.clone()
    moved[0, 8:16, 20:40] = 200.0
    _, ch_same = ops.frame_knobs(base, base)
    _, ch_moved = ops.frame_knobs(moved, base)
    assert float(ch_same[0]) == 0.0
    np.testing.assert_allclose(float(ch_moved[0]), (8 * 20) / (32 * 64),
                               rtol=1e-6)


@pytest.mark.parametrize("blur", [0, 1, 2, 5, 8, 10, 15])
def test_ops_frame_knobs_takes_the_plain_version_on_the_cpu(blur):
    f, p = (torch.from_numpy(a) for a in knob_frames(2, 20, 36, np.uint8))
    got = ops.frame_knobs(f, p, blur_k=blur, pixel_delta=12.5)
    want = FK.frame_knobs_plain(f, p, blur_k=blur, pixel_delta=12.5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_blur_is_an_edge_clamped_box():
    """Against a direct float64 reading of the definition: a k-tap box over
    ``dy in [-(k//2), k - k//2)`` with clamped rows, then columns (even k
    reaches one further back than forward)."""
    f, p = knob_frames(1, 16, 24, np.float32, seed=5)
    for k in (2, 5, 8):
        out, _ = FK.frame_knobs_plain(torch.from_numpy(f),
                                      torch.from_numpy(p), blur_k=k)
        x = f[0].astype(np.float64).reshape(8, 2, 12, 2).mean((1, 3))
        for axis in (0, 1):
            n = x.shape[axis]
            taps = [np.take(x, np.clip(np.arange(n) + d, 0, n - 1), axis)
                    for d in range(-(k // 2), k - k // 2)]
            x = np.mean(taps, axis=0)
        np.testing.assert_allclose(out[0].numpy(), x, rtol=1e-6, atol=1e-4)


def test_frame_knobs_refuses_odd_shapes():
    odd = torch.zeros((1, 5, 8))
    with pytest.raises(ValueError, match="even"):
        ops.frame_knobs(odd, odd)
    with pytest.raises(ValueError, match="one shape"):
        ops.frame_knobs(torch.zeros((1, 4, 8)), torch.zeros((1, 4, 6)))


# -- the other five wrappers, on CPU tensors ---------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(256, 512), (512, 1024), (64, 96)],
                         ids=str)
def test_ops_quantize_pair_matches_jax(jx, shape, bits):
    x = np.random.default_rng(bits).standard_normal(shape).astype(np.float32)
    q, s = ops.quantize_blocks(torch.from_numpy(x), bits=bits)
    qr, sr = jx.ref.quantize_ref(jx.jnp.asarray(x), bits=bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    d = ops.dequantize_blocks(q, s)
    assert d.dtype == torch.float32
    np.testing.assert_array_equal(d.numpy(),
                                  np.asarray(jx.ref.dequantize_ref(qr, sr)))
    # JAX's ops route (the Pallas kernels, interpreted)
    qj, sj = jx.ops.quantize_blocks(jx.jnp.asarray(x), bits=bits)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-6)
    dq = np.abs(q.numpy().astype(np.int32) - np.asarray(qj, np.int32))
    assert dq.max() <= 1 and (dq != 0).mean() < 0.01
    dj = jx.ops.dequantize_blocks(qj, sj)
    step = float(np.asarray(sj).max())
    assert np.abs(d.numpy() - np.asarray(dj)).max() <= step + 1e-7


def _attn_inputs(seed, b, sq, sk, qh, kh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, qh, d), dtype=np.float32),
            rng.standard_normal((b, sk, kh, d), dtype=np.float32),
            rng.standard_normal((b, sk, kh, d), dtype=np.float32))


@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_attention_matches_ref(jx, causal):
    q, k, v = _attn_inputs(1, 2, 64, 64, 4, 2, 32)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, block_q=16, block_k=16)
    want = jx.ref.flash_attention_ref(
        jx.jnp.asarray(q), jx.repeat_kv(jx.jnp.asarray(k), 4),
        jx.repeat_kv(jx.jnp.asarray(v), 4), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
def test_ops_decode_attention_matches_ref(jx, as_tensor):
    q, k, v = _attn_inputs(2, 2, 1, 128, 4, 2, 32)
    length = torch.tensor(77, dtype=torch.int32) if as_tensor else 77
    got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               length)
    want = jx.ref.decode_attention_ref(
        jx.jnp.asarray(q), jx.repeat_kv(jx.jnp.asarray(k), 4),
        jx.repeat_kv(jx.jnp.asarray(v), 4), jx.jnp.int32(77))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("s,block_t", [(64, 64), (96, 32), (1, 64)])
def test_ops_wkv_linear_scan_matches_ref(jx, s, block_t):
    rng = np.random.default_rng(s)
    b, h, kd = 2, 2, 16
    r, k, v = (rng.standard_normal((b, s, h, kd)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, s, h, kd)) - 1.0).astype(
        np.float32)
    u = rng.standard_normal((h, kd)).astype(np.float32)
    y, st = ops.wkv_linear_scan(*(torch.from_numpy(a) for a in
                                  (r, k, v, logw, u)), block_t=block_t)
    yr, str_ = jx.ref.wkv_ref(*(jx.jnp.asarray(a) for a in
                                (r, k, v, logw, u)))
    for got, want in ((y, yr), (st, str_)):
        want = np.asarray(want, np.float64)
        err = np.abs(got.numpy().astype(np.float64) - want).max()
        assert err <= 1e-4 * np.abs(want).max()


def test_ops_route_off_cpu_and_cuda_raises():
    """A tensor on neither the CPU nor a CUDA device never takes a plain
    version: every wrapper raises."""
    m = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.frame_knobs(m, m)
    x = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        ops.flash_attention(x, x, x)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.wkv_linear_scan(x, x, x, x, torch.zeros((2, 16), device="meta"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.quantize_blocks(torch.zeros((4, 8), device="meta"))


# -- on the card -------------------------------------------------------------


def _layout(frames, prev, layout):
    """(frames, prev) as the kernel meets them: ``"contiguous"`` as given;
    ``"offset"``: frames a contiguous view one element past its storage's
    start (a misaligned base); ``"window"``: the camera path's overlapping
    pair ``g[1:]``, ``g[:-1]`` of one buffer of N + 1 planes."""
    if layout == "offset":
        buf = torch.empty(frames.numel() + 1, dtype=frames.dtype,
                          device=frames.device)
        buf[1:] = frames.reshape(-1)
        return buf[1:].view(frames.shape), prev
    if layout == "window":
        g = torch.cat([prev[:1], frames])
        return g[1:], g[:-1]
    return frames, prev


@pytest.mark.parametrize("layout", ["contiguous", "offset", "window"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32],
                         ids=["uint8", "float32"])
@pytest.mark.parametrize("w", [240, 262])
def test_knobs_route_by_alignment(w, dtype, layout):
    """``knobs_route`` picks the vector route exactly where every row and
    both base pointers are 16-byte aligned (decided on any device)."""
    f, p = (torch.from_numpy(a).to(dtype)
            for a in knob_frames(2, 8, w, np.float32))
    f, p = _layout(f, p, layout)
    esz = f.element_size()
    aligned = (w * esz) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (f, p))
    assert FK.knobs_route(f, p) == ("vector" if aligned else "scalar")
    if layout == "offset" or w == 262:
        assert FK.knobs_route(f, p) == "scalar"
    if layout == "contiguous" and w == 240:
        assert FK.knobs_route(f, p) == "vector"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "offset", "window"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32],
                         ids=["uint8", "float32"])
@pytest.mark.parametrize("shape,blur", [((3, 64, 128), 5),
                                        ((2, 1080, 1920), 15),
                                        ((2, 1080, 1920), 5),
                                        ((4, 136, 240), 8),
                                        ((1, 48, 96), 10),
                                        ((5, 34, 1000), 1),
                                        ((3, 130, 262), 5),
                                        ((2, 18, 20), 0)], ids=str)
def test_cuda_kernel_matches_plain(shape, blur, dtype, layout):
    """The kernel bit for bit against ``frame_knobs_plain`` on the card,
    ``out`` and ``changed``, ragged tiles included, each call one launch on
    the route ``knobs_route`` names: vector where rows and bases are
    16-byte aligned (1080x1920, 136x240, the path's window of float32
    planes), scalar at W = 262 and on a misaligned base."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    f, p = (torch.from_numpy(a).cuda().to(dtype)
            for a in knob_frames(*shape, np.float32, seed=sum(shape)))
    f, p = _layout(f, p, layout)
    esz = f.element_size()
    aligned = all((shape[2] * esz) % 16 == 0 and (t.storage_offset() * esz)
                  % 16 == 0 for t in (f, p))
    route = "vector" if aligned else "scalar"
    assert FK.knobs_route(f, p) == route
    if layout == "offset" or shape[2] == 262:
        assert route == "scalar"
    n0, r0 = FK.frame_knobs.launches, dict(FK.frame_knobs.launches_by_route)
    out, ch = FK.frame_knobs(f, p, blur_k=blur)
    want_out, want_ch = FK.frame_knobs_plain(f, p, blur_k=blur)
    torch.cuda.synchronize()
    assert FK.frame_knobs.launches == n0 + 1
    assert FK.frame_knobs.launches_by_route[route] == r0[route] + 1
    assert torch.equal(out, want_out) and torch.equal(ch, want_ch)
    _, same = FK.frame_knobs(f, f, blur_k=blur)
    assert torch.equal(same, torch.zeros_like(same))
