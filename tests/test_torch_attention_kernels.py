"""The port's attention kernels against the JAX package: the plain versions
of ``flash_attention`` and ``decode_attention`` against the oracles
``repro.kernels.ref.flash_attention_ref`` / ``decode_attention_ref`` and
against the JAX model's own ``gqa_attention(impl="chunked")`` /
``decode_attention(impl="jnp")``, on the same seeded NumPy inputs.

Tolerances: float32 within 2e-5 absolute (unit-normal inputs; the sums run
in another order than XLA's); bfloat16 within 2e-2 absolute, a bfloat16
rounding of the same float32 value (the JAX model paths also round the
softmax weights to bfloat16 before the value product).

The ``cuda``-marked tests hold the CUDA kernels to their plain versions on
the card and import no JAX, so they run on a machine without it:
``python -m pytest -m cuda tests/test_torch_attention_kernels.py``.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
KH = 2


@pytest.fixture
def jx():
    """The JAX oracles, with any mesh a test before left active switched
    off (``shard`` must stay a no-op)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.models import attention as jattn
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    return types.SimpleNamespace(jnp=jnp, ref=ref, attn=jattn)


def _inputs(seed, b, sq, sk, qh, kh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, qh, d), dtype=np.float32),
            rng.standard_normal((b, sk, kh, d), dtype=np.float32),
            rng.standard_normal((b, sk, kh, d), dtype=np.float32))


def _pair(jx, arrays, dtype):
    """The same arrays for both packages, rounded once to ``dtype``."""
    jd = {"float32": jx.jnp.float32, "bfloat16": jx.jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jx.jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


FLASH_CASES = [(causal, group, s, d) for causal in (True, False)
               for group in (1, 2, 4) for s in (64, 300)
               for d in (16, 128, 112)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,group,s,d", FLASH_CASES,
                         ids=[f"{'causal' if c else 'full'}-g{g}-s{s}-d{d}"
                              for c, g, s, d in FLASH_CASES])
def test_flash_plain_matches_jax(jx, causal, group, s, d, dtype):
    arrays = _inputs(s + d + group, 2, s, s, KH * group, KH, d)
    (jq, jk, jv), (q, k, v) = _pair(jx, arrays, dtype)
    got = _f32(FA.flash_attention(q, k, v, causal=causal))
    assert got.shape == arrays[0].shape
    qh = KH * group
    want = jx.ref.flash_attention_ref(
        jq, jx.attn.repeat_kv(jk, qh), jx.attn.repeat_kv(jv, qh),
        causal=causal)
    np.testing.assert_allclose(got, _f32(want), rtol=0, atol=TOL[dtype])
    model = jx.attn.gqa_attention(jq, jk, jv, causal=causal, impl="chunked",
                                  chunk=128)
    np.testing.assert_allclose(got, _f32(model), rtol=0, atol=TOL[dtype])


DECODE_CASES = [(group, d, length) for group in (1, 2, 4)
                for d in (16, 128, 112) for length in (1, 77, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,d,length", DECODE_CASES,
                         ids=[f"g{g}-d{d}-len{n}" for g, d, n in DECODE_CASES])
def test_decode_plain_matches_jax(jx, group, d, length, dtype):
    s_max = 128                       # a shape the JAX wrapper accepts
    arrays = _inputs(length + d + group, 3, 1, s_max, KH * group, KH, d)
    (jq, jk, jv), (q, k, v) = _pair(jx, arrays, dtype)
    got = _f32(DA.decode_attention(q, k, v, length))
    want = jx.ref.decode_attention_ref(jq, jk if group == 1 else
                                       jx.attn.repeat_kv(jk, KH * group),
                                       jv if group == 1 else
                                       jx.attn.repeat_kv(jv, KH * group),
                                       jx.jnp.int32(length))
    np.testing.assert_allclose(got, _f32(want), rtol=0, atol=TOL[dtype])
    model = jx.attn.decode_attention(jq, jk, jv, jx.jnp.int32(length),
                                     impl="jnp")
    np.testing.assert_allclose(got, _f32(model), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
def test_model_prefill_impls_match_jax(jx, impl):
    """The port's ``gqa_attention`` impls against the JAX model's chunked
    path, ragged against the chunk (S=100, chunk 32)."""
    arrays = _inputs(5, 2, 100, 100, 8, KH, 16)
    (jq, jk, jv), (q, k, v) = _pair(jx, arrays, "float32")
    got = TA.gqa_attention(q, k, v, impl=impl, chunk=32)
    want = jx.attn.gqa_attention(jq, jk, jv, impl="chunked", chunk=32)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("impl", ["einsum", "kernel"])
@pytest.mark.parametrize("length", [1, 40, 64])
def test_model_decode_impls_match_jax(jx, impl, length):
    arrays = _inputs(length, 2, 1, 64, 4, KH, 16)
    (jq, jk, jv), (q, k, v) = _pair(jx, arrays, "float32")
    got = TA.decode_attention(q, k, v, length, impl=impl)
    want = jx.attn.decode_attention(jq, jk, jv, jx.jnp.int32(length),
                                    impl="jnp")
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=2e-5)


LSE_CASES = [(1, 16, 1), (2, 128, 77), (4, 112, 128)]


def _numpy_lse(q, k, length, scale):
    """float64 log-sum-exp of each q head's scaled scores over the first
    ``length`` rows: q ``[B, 1, QH, D]``, k ``[B, S, KH, D]`` ->
    ``[B, QH]``."""
    q, k = q.astype(np.float64), k.astype(np.float64)
    g = q.shape[2] // k.shape[2]
    kx = np.repeat(k[:, :length], g, axis=2)
    s = np.einsum("bqhd,bkhd->bhk", q, kx) * scale
    top = s.max(-1, keepdims=True)
    return (top + np.log(np.exp(s - top).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("group,d,length", LSE_CASES,
                         ids=[f"g{g}-d{d}-len{n}" for g, d, n in LSE_CASES])
def test_decode_plain_lse_matches_numpy(group, d, length):
    """The plain version's log-sum-exp against NumPy's, and its output
    unchanged by asking for it."""
    arrays = _inputs(length + d, 3, 1, 128, KH * group, KH, d)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    out, lse = DA.decode_attention(q, k, v, length, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (3, KH * group)
    assert torch.equal(out, DA.decode_attention(q, k, v, length))
    want = _numpy_lse(arrays[0], arrays[1], length, d ** -0.5)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)
    for impl in ("einsum", "kernel"):
        o2, l2 = TA.decode_attention(q, k, v, length, impl=impl,
                                     return_lse=True)
        np.testing.assert_allclose(l2.numpy(), want, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(_f32(o2), _f32(out), rtol=0, atol=2e-6)


@pytest.mark.parametrize("length", [1, 70, 100, 128])
def test_decode_lse_merge_of_row_shards_equals_whole(length):
    """Four row shards of one cache (32 rows each, as a model axis of 4
    splits a sequence-sharded cache), each attended over its own valid
    rows -- a shard with none gives zeros and ``-inf`` -- merged by their
    log-sum-exps as ``merge_decode_partials`` merges the ranks' partials,
    equal to the whole cache's attention and log-sum-exp."""
    arrays = _inputs(length, 2, 1, 128, 8, KH, 16)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    whole, whole_lse = TA.decode_attention(q, k, v, length,
                                           return_lse=True)
    outs, lses = [], []
    for r in range(4):
        rows = slice(32 * r, 32 * (r + 1))
        valid = min(max(length - 32 * r, 0), 32)
        o, lse = TA.decode_attention(q, k[:, rows].contiguous(),
                                     v[:, rows].contiguous(), valid,
                                     impl="kernel", return_lse=True)
        if valid == 0:
            assert not o.any() and torch.isneginf(lse).all()
        outs.append(o.double())
        lses.append(lse.double())
    every = torch.stack(lses)
    top = every.amax(0)
    merged = sum(torch.exp(l - top)[:, None, :, None] * o
                 for o, l in zip(outs, lses)) / torch.exp(every - top).sum(0)[
                     :, None, :, None]
    merged_lse = top + torch.log(torch.exp(every - top).sum(0))
    np.testing.assert_allclose(merged.numpy(), whole.double().numpy(),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(merged_lse.numpy(),
                               whole_lse.double().numpy(), rtol=0,
                               atol=2e-5)


def test_wrappers_check_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 8, 8, 4, 2, 16))
    with pytest.raises(RuntimeError, match="do not match"):
        FA.flash_attention(q, k[..., :8], v[..., :8])
    with pytest.raises(RuntimeError, match="dtypes differ"):
        FA.flash_attention(q, k.double(), v)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        FA.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    q1 = q[:, :1]
    with pytest.raises(RuntimeError, match="length"):
        DA.decode_attention(q1, k, v, 0)
    with pytest.raises(RuntimeError, match="length"):
        DA.decode_attention(q1, k, v, 9)
    with pytest.raises(RuntimeError, match=r"\[B,1,QH,D\]"):
        DA.decode_attention(q, k, v, 4)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        DA.decode_attention(q1.to("meta"), k.to("meta"), v.to("meta"), 4)
    with pytest.raises(ValueError, match="unknown"):
        TA.gqa_attention(q, k, v, impl="pallas")


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "ffma"), (torch.bfloat16, 32, "ffma"),
    (torch.float32, 16, "ffma"), (torch.float32, 32, "ffma"),
    (torch.float32, 64, "ffma"), (torch.float32, 128, "ffma"),
    (torch.bfloat16, 112, "wgmma"), (torch.float32, 112, "ffma")])
def test_flash_route_choice(dtype, d, route):
    """bfloat16 at D 64/112/128 takes the tensor-core route, float32 and
    the narrow bfloat16 heads the f32 CUDA-core route."""
    assert FA.flash_route(dtype, d) == route


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (torch.float64, 128),
                                     (torch.bfloat16, 96), (torch.float32, 8),
                                     (torch.bfloat16, 256)])
def test_flash_route_refuses(dtype, d):
    with pytest.raises(RuntimeError, match="the kernel takes"):
        FA.flash_route(dtype, d)


def test_cpu_calls_do_not_count_as_launches():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 8, 8, 4, 2, 16))
    before = (FA.flash_attention.launches, DA.decode_attention.launches)
    routes = dict(FA.flash_attention.launches_by_route)
    FA.flash_attention(q, k, v)
    DA.decode_attention(q[:, :1], k, v, 8)
    assert (FA.flash_attention.launches,
            DA.decode_attention.launches) == before
    assert FA.flash_attention.launches_by_route == routes


# -- on the card ---------------------------------------------------------------

# the zoo's other head shapes (QH, KH): moonshot-v1-16b-a3b (16, 16),
# llama3-8b and phi3.5-moe-42b-a6.6b (32, 8), phi3-medium-14b (40, 10)
ZOO_HEADS = ((16, 16), (32, 8), (40, 10))
# head_dim 112 (zamba2-7b: QH 32 = KH, G = 1; and G = 8) and G = 8 at
# D = 128 (qwen2-vl-72b: QH 64, KH 8, a 2048-row prefill)
CUDA_FLASH = [(1, 64, 2, 1, 128), (2, 200, 4, 2, 64),          # small
              (8, 1024, 16, 8, 128), (8, 1000, 16, 8, 128),    # serving
              *((8, 1024, qh, kh, 128) for qh, kh in ZOO_HEADS),
              (8, 1024, 32, 32, 112), (2, 200, 8, 1, 112),
              (2, 65, 32, 32, 112), (4, 2048, 64, 8, 128)]
CUDA_DECODE = [(1, 64, 2, 1, 128, 37), (2, 256, 8, 2, 16, 256),
               (8, 1536, 16, 8, 128, 1), (8, 1536, 16, 8, 128, 1279),
               *((8, 1536, qh, kh, 128, n) for qh, kh in ZOO_HEADS
                 for n in (1, 1152)),
               *((8, 1536, 32, 32, 112, n) for n in (1, 1152, 1536)),
               (2, 256, 8, 1, 112, 200), (8, 2560, 64, 8, 128, 2304)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("b,s,qh,kh,d", CUDA_FLASH,
                         ids=[f"b{c[0]}-s{c[1]}-h{c[2]}x{c[3]}-d{c[4]}"
                              for c in CUDA_FLASH])
def test_cuda_flash_kernel_matches_plain(card, b, s, qh, kh, d, causal,
                                         dtype):
    q, k, v = (torch.from_numpy(a).to(card, dtype)
               for a in _inputs(s, b, s, s, qh, kh, d))
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[str(dtype).removeprefix("torch.")], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b,s_max,qh,kh,d,length", CUDA_DECODE,
                         ids=[f"b{c[0]}-s{c[1]}-h{c[2]}x{c[3]}-d{c[4]}-"
                              f"len{c[5]}" for c in CUDA_DECODE])
def test_cuda_decode_kernel_matches_plain(card, b, s_max, qh, kh, d, length,
                                          dtype):
    q, k, v = (torch.from_numpy(a).to(card, dtype)
               for a in _inputs(length, b, 1, s_max, qh, kh, d))
    before = DA.decode_attention.launches
    got = DA.decode_attention(q, k, v, length)
    want = DA.decode_attention_plain(q, k, v, length)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == before + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[str(dtype).removeprefix("torch.")], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b,s_max,qh,kh,d,length", CUDA_DECODE,
                         ids=[f"b{c[0]}-s{c[1]}-h{c[2]}x{c[3]}-d{c[4]}-"
                              f"len{c[5]}" for c in CUDA_DECODE])
def test_cuda_decode_lse_matches_plain(card, b, s_max, qh, kh, d, length,
                                       dtype):
    """The kernel's log-sum-exp row by row against the plain version's,
    its output the same bits as without it, one launch counted on both
    counters."""
    q, k, v = (torch.from_numpy(a).to(card, dtype)
               for a in _inputs(length, b, 1, s_max, qh, kh, d))
    before = (DA.decode_attention.launches,
              DA.decode_attention.lse_launches)
    got, lse = DA.decode_attention(q, k, v, length, return_lse=True)
    plain = DA.decode_attention(q, k, v, length)
    _, want = DA.decode_attention_plain(q, k, v, length, return_lse=True)
    torch.cuda.synchronize()
    assert (DA.decode_attention.launches,
            DA.decode_attention.lse_launches) == (before[0] + 2,
                                                   before[1] + 1)
    assert torch.equal(got, plain)
    err = ((lse - want).abs() / want.abs().clamp_min(1.0)).max().item()
    assert err <= 1e-5, err


# the tensor-core route at every edge of its 128-row blocks and 64-key
# tiles: (group, S) for B=2, KH=2
WGMMA_SEQS = (1, 63, 64, 65, 200, 1000, 1024)
WGMMA_CASES = [(g, s) for g in (1, 2, 4, 8) for s in WGMMA_SEQS]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 112])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("group,s", WGMMA_CASES,
                         ids=[f"g{g}-s{s}" for g, s in WGMMA_CASES])
def test_cuda_flash_wgmma_route(card, group, s, causal, d):
    q, k, v = (torch.from_numpy(a).to(card, torch.bfloat16)
               for a in _inputs(s + group, 2, s, s, KH * group, KH, d))
    before = dict(FA.flash_attention.launches_by_route)
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    after = FA.flash_attention.launches_by_route
    assert after["wgmma"] == before["wgmma"] + 1
    assert after["ffma"] == before["ffma"]
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL["bfloat16"], err


# lengths at the edges of the kernel's chunks and splits, in a cache whose
# S_max no split size divides
DECODE_EDGE_LENGTHS = (1, 127, 128, 129, 1152, 1536)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("length", DECODE_EDGE_LENGTHS)
def test_cuda_decode_one_launch_bit_stable(card, length, dtype):
    b, s_max, qh, kh, d = 8, 1543, 16, 8, 128
    q, k, v = (torch.from_numpy(a).to(card, dtype)
               for a in _inputs(length, b, 1, s_max, qh, kh, d))
    before = DA.decode_attention.launches
    got = DA.decode_attention(q, k, v, length)
    again = DA.decode_attention(q, k, v, length)
    want = DA.decode_attention_plain(q, k, v, length)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == before + 2
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[str(dtype).removeprefix("torch.")], err


def test_flash_launch_limits():
    """The wrappers refuse what the kernels cannot index, and let through
    what their 64-bit offsets hold: qwen3's whole ``prefill_32k`` q is
    2^31 elements (32 x 32768 x 16 x 128)."""
    FA.launch_limits(32, 32768, 32768, 16, 8, 128, "wgmma")
    FA.launch_limits(32, 32768, 32768, 16, 8, 128, "ffma")
    assert 32 * 32768 * 16 * 128 == 2 ** 31
    with pytest.raises(RuntimeError, match="grid extents"):
        FA.launch_limits(65536, 64, 64, 16, 8, 128, "wgmma")
    with pytest.raises(RuntimeError, match="grid extents"):
        FA.launch_limits(1, 65535 * 128 + 1, 64, 16, 8, 128, "wgmma")
    with pytest.raises(RuntimeError, match="grid extents"):
        FA.launch_limits(1, 64, 64, 65536, 8, 128, "ffma")
    with pytest.raises(RuntimeError, match="32-bit"):
        FA.launch_limits(1, 2 ** 31, 64, 16, 8, 128, "ffma")


def test_decode_launch_limits():
    """zamba2's ``long_500k`` layer cache (524544 x 32 x 112 bf16, 3.76 GB
    a tensor) passes; a batch past the grid's z extent does not."""
    DA.launch_limits(1, 524544, 32, 32, 112)
    with pytest.raises(RuntimeError, match="grid extents"):
        DA.launch_limits(65536, 64, 8, 8, 128)
    with pytest.raises(RuntimeError, match="32-bit"):
        DA.launch_limits(1, 2 ** 31, 8, 8, 128)


# At long context an absolute limit sees nothing (decode over 524288
# unit-normal keys gives |o| ~ 2e-3), so the long-context shapes are held
# row by row: the largest over rows of ||kernel - plain|| / ||plain||.
# Sound, the two round apart by about a bf16 step in some of a row's
# values; skipping m of n near-uniform keys moves a row by ~sqrt(m e / n).
ROW_RTOL = 2.0 ** -6


def _row_rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return (torch.linalg.vector_norm(got - want, dim=-1)
            / torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30)
            ).max().item()


@pytest.mark.cuda
def test_cuda_long_context_shapes(card):
    """The kernels at the dry-run's long-context shapes, bfloat16, on
    seeded unit-normal inputs, held row by row (``ROW_RTOL``), and planted
    faults shown to fail that check: decode over 524288 of 524544 cache
    rows at zamba2's heads (``long_500k``: 32 heads of 112, G 1; a cache
    tensor 3.76 GB, past 32-bit byte offsets) against
    ``decode_attention_plain``, with its last split of 8 or its last 256
    rows skipped as the faults; flash at qwen3's ``prefill_32k`` shape cut
    to batch 2 (S 32768, QH 16 over KH 8, D 128, causal, on ``wgmma``) --
    the plain version's float32 scores would take 137 GB, so batch row 0
    is held, all its 32768 query rows, against the chunked plain route
    (``models.attention``, ``impl="chunked"``) -- with its last key tile
    read from the tile before as the fault."""
    g = torch.Generator(device=card)
    g.manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=card).to(
            torch.bfloat16)

    s_max, length = 524288 + 256, 524288
    q, kc, vc = normal(1, 1, 32, 112), normal(1, s_max, 32, 112), \
        normal(1, s_max, 32, 112)
    before = DA.decode_attention.launches
    got = DA.decode_attention(q, kc, vc, length)
    want = DA.decode_attention_plain(q, kc, vc, length)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == before + 1
    assert _row_rel_err(got, want) <= ROW_RTOL
    for skipped in (length // 8, 256):
        fault = DA.decode_attention(q, kc, vc, length - skipped)
        assert _row_rel_err(fault, want) > ROW_RTOL, skipped
    del q, kc, vc, got, want, fault
    torch.cuda.empty_cache()
    q, k, v = normal(2, 32768, 16, 128), normal(2, 32768, 8, 128), \
        normal(2, 32768, 8, 128)
    before = dict(FA.flash_attention.launches_by_route)
    got = FA.flash_attention(q, k, v, causal=True)
    assert FA.flash_attention.launches_by_route["wgmma"] == \
        before["wgmma"] + 1
    want = TA.gqa_attention(q[:1], k[:1], v[:1], causal=True,
                            impl="chunked")
    torch.cuda.synchronize()
    assert _row_rel_err(got[:1], want) <= ROW_RTOL
    kf, vf = k[:1].clone(), v[:1].clone()
    kf[:, -64:], vf[:, -64:] = k[:1, -128:-64], v[:1, -128:-64]
    fault = FA.flash_attention(q[:1], kf, vf, causal=True)
    assert _row_rel_err(fault, want) > ROW_RTOL
