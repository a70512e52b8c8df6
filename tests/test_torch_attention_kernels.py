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
