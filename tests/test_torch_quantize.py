"""The port's block quantization (``repro_torch.kernels.quantize``) against
the JAX package: the plain pair bit for bit against the oracles
``repro.kernels.ref.quantize_ref`` / ``dequantize_ref`` (which the JAX
approximate collective calls), and against the Pallas kernels in interpret
mode as ``tests/test_kernels.py::TestQuantize`` holds those: |dq| <= 1 on
fewer than 1% of the elements (the interpreted kernel divides by the scale
through a reciprocal, and lands one level away at some ties).

Inputs: seeded unit-normal NumPy draws times a scale from 1e-8 to 1e4;
bfloat16 inputs are the same draws cast in both packages.  Edge cases: a
tile smaller than the block (``min(block, shape)``), an all-zero tile
(scale 1e-12, q all 0), constructed ``.5`` ties (half to even), values at
+-absmax, bits 4.

The round-trip bound ``|x' - x| <= scale / 2`` is held with a relative
slack (4 float32 ulps of |x|): the JAX property test's absolute 1e-7
slack is below one ulp of |x| > 1 and fails at its seed 65 (ROADMAP
Queue 3).

The route a CUDA call takes (``route_for``) is a choice by shape: every
gradient leaf of the full-width ``qwen3-1.7b`` step, padded as the
approximate collective pads it, takes the contiguous route.

The ``cuda``-marked tests hold the kernels to the plain versions bit for
bit on the card, each launch on the route ``route_for`` names, at the
clustered quantize's and the flat dequantize's edges (one tile, seven
tiles, a short tile, a strided layout, misaligned pointers, an all-zero
tile); they import no JAX:
``python -m pytest -m cuda tests/test_torch_quantize.py``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import quantize as Q  # noqa: E402

SCALES = [1e-8, 1e-3, 1.0, 1e4]


def draw(shape, *, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import quantize as JQ
    from repro.kernels import ref
    return jnp, ref, JQ


def both(jnp, x, dtype):
    """x as (a JAX array, a torch tensor) of ``dtype`` ("f32"/"bf16")."""
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bf16":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    return xj, xt


def assert_same(jnp, got_q, got_s, want_q, want_s):
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scale", SCALES)
def test_plain_pair_matches_ref_bitwise(jx, scale, dtype, bits):
    jnp, ref, _ = jx
    for seed in range(2):
        xj, xt = both(jnp, draw((512, 1024), seed=seed, scale=scale), dtype)
        qr, sr = ref.quantize_ref(xj, bits=bits)
        q, s = Q.quantize_blocks_plain(xt, bits=bits)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert_same(jnp, q, s, qr, sr)
        for out in ("f32", "bf16"):
            jd = jnp.float32 if out == "f32" else jnp.bfloat16
            td = torch.float32 if out == "f32" else torch.bfloat16
            want = ref.dequantize_ref(qr, sr, out_dtype=jd)
            got = Q.dequantize_blocks_plain(q, s, out_dtype=td)
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(128, 256), (256, 1536), (1024, 100),
                                   (64, 512)])
def test_tile_is_min_of_block_and_shape(jx, shape):
    jnp, ref, _ = jx
    xj, xt = both(jnp, draw(shape, seed=4), "f32")
    qr, sr = ref.quantize_ref(xj)
    q, s = Q.quantize_blocks(xt)
    assert tuple(s.shape) == (shape[0] // min(256, shape[0]),
                              shape[1] // min(512, shape[1]))
    assert_same(jnp, q, s, qr, sr)
    np.testing.assert_array_equal(Q.dequantize_blocks(q, s).numpy(),
                                  np.asarray(ref.dequantize_ref(qr, sr)))


@pytest.mark.parametrize("shape,block", [((300, 512), (256, 512)),
                                         ((256, 700), (256, 512))])
def test_tile_must_divide_the_shape(shape, block):
    with pytest.raises(ValueError, match="does not divide"):
        Q.quantize_blocks(torch.zeros(shape), block=block)
    with pytest.raises(ValueError, match="does not divide"):
        Q.dequantize_blocks(torch.zeros(shape, dtype=torch.int8),
                            torch.ones((1, 1)), block=block)


def test_bits_must_be_8_or_4():
    with pytest.raises(ValueError, match="bits"):
        Q.quantize_blocks(torch.zeros((256, 512)), bits=6)


def edge_input():
    """[512, 1024]: tile (0, 0) all zero; tile (0, 1) ties at absmax 127
    (scale exactly 1, every value k + 0.5); tile (1, 0) ties at absmax 7
    for bits 4; tile (1, 1) values at +-absmax and zero."""
    x = np.zeros((512, 1024), np.float32)
    ties = (np.arange(256 * 512) % 254 - 127 + 0.5).astype(np.float32)
    x[:256, 512:] = ties.reshape(256, 512)
    x[0, 512] = 127.0
    small = (np.arange(256 * 512) % 14 - 7 + 0.5).astype(np.float32)
    x[256:, :512] = small.reshape(256, 512)
    x[256, 0] = -7.0
    x[256:, 512:] = np.where(np.arange(512) % 3 == 0, 3.25,
                             np.where(np.arange(512) % 3 == 1, -3.25, 0.0))
    return x


@pytest.mark.parametrize("bits", [8, 4])
def test_edge_cases_match_ref(jx, bits):
    jnp, ref, _ = jx
    x = edge_input()
    qr, sr = ref.quantize_ref(jnp.asarray(x), bits=bits)
    q, s = Q.quantize_blocks(torch.from_numpy(x), bits=bits)
    assert_same(jnp, q, s, qr, sr)
    assert float(s[0, 0]) == np.float32(1e-12) and not q[:256, :512].any()
    qmax = Q.QMAX[bits]
    assert int(q.abs().max()) == qmax
    if bits == 8:
        # absmax 127: scale 1, so q is x rounded half to even
        assert float(s[0, 1]) == 1.0
        np.testing.assert_array_equal(q[:256, 512:].numpy(),
                                      np.round(x[:256, 512:]))
    else:
        assert float(s[1, 0]) == 1.0
        np.testing.assert_array_equal(q[256:, :512].numpy(),
                                      np.round(x[256:, :512]))


@pytest.mark.parametrize("shape", [(256, 512), (512, 1024), (256, 1536)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_against_pallas_interpret(jx, shape, bits, dtype):
    """Held as ``tests/test_kernels.py::TestQuantize`` holds the Pallas
    kernel against the oracle."""
    jnp, _, JQ = jx
    xj, xt = both(jnp, draw(shape, seed=0), dtype)
    qk, sk = JQ.quantize_blocks(xj, bits=bits, interpret=True)
    q, s = Q.quantize_blocks(xt, bits=bits)
    np.testing.assert_allclose(s.numpy(), np.asarray(sk), rtol=1e-6)
    d = np.abs(q.numpy().astype(np.int32) - np.asarray(qk, np.int32))
    assert d.max() <= 1 and (d != 0).mean() < 0.01
    xd = Q.dequantize_blocks(q, s).numpy()
    xdk = np.asarray(JQ.dequantize_blocks(qk, sk, interpret=True))
    step = np.repeat(np.repeat(s.numpy(), min(256, shape[0]), 0),
                     min(512, shape[1]), 1)
    assert np.abs(xd - xdk).max() <= step.max() * (1 + 1e-6)


def roundtrip_bounded(x, bits):
    q, s = Q.quantize_blocks(torch.from_numpy(x), bits=bits)
    xd = Q.dequantize_blocks(q, s).numpy()
    step = np.repeat(np.repeat(s.numpy(), 256, 0), 512, 1)
    slack = 4 * np.finfo(np.float32).eps * np.abs(x)
    return bool((np.abs(xd - x) <= step * 0.5 + slack).all())


@pytest.mark.parametrize("bits", [8, 4])
def test_roundtrip_bounded_by_half_step(bits):
    for seed in range(40):
        x = draw((256, 512), seed=seed, scale=10.0 ** (seed % 9 - 4))
        assert roundtrip_bounded(x, bits), seed


def test_roundtrip_bound_at_the_jax_seed_65(jx):
    """The input on which the JAX property test's absolute slack fails."""
    pytest.importorskip("jax")
    import jax
    x = np.array(jax.random.normal(jax.random.PRNGKey(65), (256, 512)))
    for bits in (8, 4):
        assert roundtrip_bounded(x, bits)


def test_wrappers_take_the_plain_route_on_the_cpu_only():
    x = torch.from_numpy(draw((256, 512), seed=2))
    before = (Q.quantize_blocks.launches, Q.dequantize_blocks.launches)
    by_route = (dict(Q.quantize_blocks.launches_by_route),
                dict(Q.dequantize_blocks.launches_by_route))
    q, s = Q.quantize_blocks(x)
    Q.dequantize_blocks(q, s)
    assert (Q.quantize_blocks.launches,
            Q.dequantize_blocks.launches) == before
    assert (Q.quantize_blocks.launches_by_route,
            Q.dequantize_blocks.launches_by_route) == by_route
    meta = torch.zeros((256, 512), device="meta")
    with pytest.raises(RuntimeError, match="CUDA device"):
        Q.quantize_blocks(meta)
    with pytest.raises(RuntimeError, match="CUDA device"):
        Q.dequantize_blocks(torch.zeros((256, 512), dtype=torch.int8,
                                        device="meta"),
                            torch.ones((1, 1), device="meta"))


def qwen3_leaf_shapes():
    """(key, the 2-D shape ``approx_comm._pad_2d`` gives it) of every
    gradient leaf the full-width ``qwen3-1.7b`` step quantizes (at least
    1024 elements: ``launch/train.py``'s ``min_size``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.approx_comm import _pad_2d
    from repro_torch.models.transformer import param_shapes
    from repro_torch.tree import tree_items
    out = []
    for key, shape in tree_items(param_shapes(get_config("qwen3-1.7b"))):
        if math.prod(shape) >= 1024:
            x2d, _ = _pad_2d(torch.empty(shape, device="meta"))
            out.append((key, tuple(x2d.shape)))
    return out


def test_training_leaves_take_the_contiguous_route():
    leaves = qwen3_leaf_shapes()
    assert len(leaves) == 13
    assert {shape for _, shape in leaves} >= {(688128, 512), (608256, 512),
                                              (229376, 512), (114688, 512),
                                              (256, 512)}
    for key, shape in leaves:
        assert Q.route_for(shape) == "contiguous", key


@pytest.mark.parametrize("shape,route", [
    ((256, 512), "contiguous"), ((256 * 7, 512), "contiguous"),
    ((128, 512), "contiguous"), ((1024, 100), "contiguous"),
    ((64, 6), "contiguous"), ((256, 1536), "strided"),
    ((512, 1024), "strided"), ((128, 256), "contiguous")], ids=str)
def test_route_for(shape, route):
    """Contiguous wherever the tile spans whole rows (N == min(bn, N))."""
    assert Q.route_for(shape) == route
    assert route in Q.ROUTES


def test_route_for_needs_a_dividing_tile():
    with pytest.raises(ValueError, match="does not divide"):
        Q.route_for((300, 512))
    assert Q.route_for((256, 1024), block=(256, 1024)) == "contiguous"


# -- on the card --------------------------------------------------------------


CUDA_SHAPES = [(256, 512), (512, 1024), (4096, 512), (128, 256), (1024, 100),
               (64, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CUDA_SHAPES, ids=str)
def test_cuda_kernels_match_plain(shape, dtype, bits):
    """Both kernels bit for bit against their plain versions on the card,
    over scales from 1e-8 to 1e4 (the ragged shapes take the kernels'
    one-element path)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for i, scale in enumerate(SCALES):
        x = torch.from_numpy(draw(shape, seed=i, scale=scale)).cuda().to(
            dtype)
        n0 = Q.quantize_blocks.launches
        q, s = Q.quantize_blocks(x, bits=bits)
        qp, sp = Q.quantize_blocks_plain(x, bits=bits)
        torch.cuda.synchronize()
        assert Q.quantize_blocks.launches == n0 + 1
        assert torch.equal(q, qp) and torch.equal(s, sp)
        for out in (torch.float32, torch.bfloat16):
            d = Q.dequantize_blocks(q, s, out_dtype=out)
            dp = Q.dequantize_blocks_plain(q, s, out_dtype=out)
            torch.cuda.synchronize()
            assert d.dtype == out and torch.equal(d, dp)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_edge_cases_match_plain(bits):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    x = torch.from_numpy(edge_input()).cuda()
    q, s = Q.quantize_blocks(x, bits=bits)
    qp, sp = Q.quantize_blocks_plain(x, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert torch.equal(Q.dequantize_blocks(q, s),
                       Q.dequantize_blocks_plain(q, s))
    assert float(s[0, 0]) == np.float32(1e-12)


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def check_on_card(x, bits, dq_input=None):
    """Both kernels bitwise against the plain versions on CUDA ``x``,
    dequantize also on ``dq_input(q)`` when given (a misaligned copy), and
    every launch on the route ``route_for`` names."""
    route = Q.route_for(x.shape)
    n0 = (dict(Q.quantize_blocks.launches_by_route),
          dict(Q.dequantize_blocks.launches_by_route))
    q, s = Q.quantize_blocks(x, bits=bits)
    qp, sp = Q.quantize_blocks_plain(x, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(q, qp) and torch.equal(s, sp)
    qd = q if dq_input is None else dq_input(q)
    for out in (torch.float32, torch.bfloat16):
        d = Q.dequantize_blocks(qd, s, out_dtype=out)
        dp = Q.dequantize_blocks_plain(q, s, out_dtype=out)
        torch.cuda.synchronize()
        assert d.dtype == out and torch.equal(d, dp)
    n1 = (Q.quantize_blocks.launches_by_route,
          Q.dequantize_blocks.launches_by_route)
    for before, after, want in zip(n0, n1, (1, 2)):
        assert {r: after[r] - before[r] for r in Q.ROUTES} == {
            r: want if r == route else 0 for r in Q.ROUTES}
    return q, s


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(256, 512), (256 * 7, 512), (128, 512),
                                   (512, 1024), (256 * 100, 512),
                                   (2560, 5120)], ids=str)
def test_cuda_cluster_and_stream_edges(shape, dtype, bits):
    """One tile (a one-tile leaf: one cluster, a grid the chunks cap),
    seven tiles (no multiple of a cluster's or a grid's share), a short
    tile (M < 256: each CTA half full), a strided layout (N > bn), and a
    hundred tiles on each layout: several times the clusters the card
    holds at once, so each persistent cluster walks tiles k >= 1 through
    both halves of its double-buffered partial maxima."""
    need_cuda()
    for i, scale in enumerate(SCALES):
        x = torch.from_numpy(draw(shape, seed=10 + i, scale=scale)).cuda()
        check_on_card(x.to(dtype), bits)


def misaligned(x):
    """A copy of ``x`` whose storage starts one element past a 16-byte
    boundary: contiguous, the same shape."""
    out = x.new_empty(x.numel() + 1)[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(256 * 7, 512), (512, 1024)], ids=str)
def test_cuda_misaligned_pointers_match_plain(shape, dtype):
    """The wrappers admit a contiguous tensor at an odd offset: the kernels
    take one element a lane there, bitwise as on aligned tensors."""
    need_cuda()
    x = torch.from_numpy(draw(shape, seed=5, scale=3.0)).cuda().to(dtype)
    check_on_card(misaligned(x), 8, dq_input=misaligned)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_all_zero_tile(dtype, bits):
    """Tile 1 of three all zero: scale 1e-12 (the floor), q and the
    dequantized tile all zero; its neighbours as the plain version."""
    need_cuda()
    x = torch.from_numpy(draw((768, 512), seed=6)).cuda().to(dtype)
    x[256:512] = 0
    q, s = check_on_card(x, bits)
    assert float(s[1, 0]) == np.float32(1e-12)
    assert not q[256:512].any()
    assert not Q.dequantize_blocks(q, s)[256:512].any()
