"""The port's wkv recurrence (``repro_torch.kernels.linear_scan``) against
the JAX package: ``wkv_plain`` against the JAX model's own
``models/rwkv6.py::wkv_chunked`` and the step-by-step oracle
``repro.kernels.ref.wkv_ref``, on the same seeded NumPy inputs.

Inputs: r, k, v, u unit normal; ``logw = -exp(N(0, 1) - 1)`` (decays from
~0.95 down to ~1e-3); ``state0`` unit normal or None.  Tolerances, as a
share of the reference's max |.|: against ``wkv_chunked`` (the same
algorithm in the same op order) 1e-5, float32 products summed in another
order; against ``wkv_ref`` 1e-4, since the chunked form takes each decay
as ``exp`` of a difference of cumulative sums over up to 64 steps where
the oracle multiplies ``exp(logw)`` step by step.  bfloat16 r/k/v (cast
from the same float32 draws in both packages): y within one bfloat16 step
(2^-7 of max |y|), the float32 state as float32.

``kernel_order`` models the CUDA kernel's arithmetic order in NumPy and is
held to the oracle and ``wkv_plain`` at S=1024 within the card's tolerance.
The ``cuda``-marked tests hold the kernel against ``wkv_plain`` on the
card; they import no JAX:
``python -m pytest -m cuda tests/test_torch_linear_scan.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import linear_scan as LS  # noqa: E402

BF16_STEP = 2.0 ** -7


def inputs(b, s, h, kd, *, seed=0, state=True):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, kd)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, s, h, kd)) - 1.0).astype(
        np.float32)
    u = rng.standard_normal((h, kd)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, kd, kd)).astype(np.float32)
          if state else None)
    return r, k, v, logw, u, s0


def share(got, want):
    """max |got - want| as a share of max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def port(r, k, v, logw, u, s0, *, dtype=torch.float32, chunk=64):
    t = [torch.from_numpy(x).to(dtype) for x in (r, k, v)]
    y, st = LS.wkv_plain(*t, torch.from_numpy(logw), torch.from_numpy(u),
                         state0=None if s0 is None else torch.from_numpy(s0),
                         chunk=chunk)
    assert y.dtype == dtype and st.dtype == torch.float32
    return y.float().numpy(), st.numpy()


@pytest.fixture
def jx():
    """The JAX package's two wkv functions, with any mesh a test before
    left active switched off (``launch/steps.py`` activates one)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ref import wkv_ref
    from repro.models.rwkv6 import wkv_chunked
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    return jnp, wkv_chunked, wkv_ref


def jax_call(jnp, fn, r, k, v, logw, u, s0, *, dtype, **kw):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rj, kj, vj = (jnp.asarray(x).astype(jd) for x in (r, k, v))
    y, st = fn(rj, kj, vj, jnp.asarray(logw), jnp.asarray(u),
               state0=None if s0 is None else jnp.asarray(s0), **kw)
    assert y.dtype == jd
    return np.asarray(y.astype(jnp.float32)), np.asarray(st)


SHAPES = [  # (B, S, H, K, chunk)
    (1, 1, 1, 16, 64),
    (2, 16, 2, 16, 4),
    (2, 64, 3, 16, 16),
    (1, 96, 2, 32, 32),
    (2, 128, 2, 64, 64),
]


@pytest.mark.parametrize("state", [False, True], ids=["zero", "state0"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_plain_matches_wkv_chunked_and_ref_f32(jx, shape, state):
    jnp, wkv_chunked, wkv_ref = jx
    b, s, h, kd, chunk = shape
    args = inputs(b, s, h, kd, state=state)
    y, st = port(*args, chunk=chunk)
    yc, stc = jax_call(jnp, wkv_chunked, *args, dtype=torch.float32,
                       chunk=chunk)
    yr, str_ = jax_call(jnp, wkv_ref, *args, dtype=torch.float32)
    assert share(y, yc) <= 1e-5 and share(st, stc) <= 1e-5
    assert share(y, yr) <= 1e-4 and share(st, str_) <= 1e-4


@pytest.mark.parametrize("state", [False, True], ids=["zero", "state0"])
@pytest.mark.parametrize("shape", SHAPES[1:4:2],
                         ids=lambda s: "-".join(map(str, s)))
def test_plain_matches_wkv_chunked_and_ref_bf16(jx, shape, state):
    jnp, wkv_chunked, wkv_ref = jx
    b, s, h, kd, chunk = shape
    args = inputs(b, s, h, kd, seed=1, state=state)
    y, st = port(*args, dtype=torch.bfloat16, chunk=chunk)
    yc, stc = jax_call(jnp, wkv_chunked, *args, dtype=torch.bfloat16,
                       chunk=chunk)
    yr, str_ = jax_call(jnp, wkv_ref, *args, dtype=torch.bfloat16)
    assert share(y, yc) <= BF16_STEP and share(y, yr) <= BF16_STEP
    assert share(st, stc) <= 1e-5 and share(st, str_) <= 1e-4


def test_chunks_compose_into_one_scan():
    """A prefix and then the rest from its state equals one call (what
    prefill followed by decode steps relies on)."""
    r, k, v, logw, u, s0 = inputs(2, 32, 2, 16, seed=3)
    t = [torch.from_numpy(x) for x in (r, k, v, logw)]
    ut, s0t = torch.from_numpy(u), torch.from_numpy(s0)
    y, st = LS.wkv_plain(*t, ut, state0=s0t, chunk=8)
    y1, st1 = LS.wkv_plain(*(x[:, :24] for x in t), ut, state0=s0t, chunk=8)
    ys = [y1]
    for i in range(24, 32):
        yi, st1 = LS.wkv_plain(*(x[:, i:i + 1] for x in t), ut, state0=st1,
                               chunk=8)
        ys.append(yi)
    assert share(torch.cat(ys, 1), y) <= 1e-5 and share(st1, st) <= 1e-5


@pytest.mark.parametrize("s,chunk", [(12, 8), (1000, 64)])
def test_chunk_must_divide_the_sequence(s, chunk):
    r, k, v, logw, u, _ = inputs(1, s, 1, 16, state=False)
    t = [torch.from_numpy(x) for x in (r, k, v, logw)]
    for impl in ("kernel", "chunked"):
        with pytest.raises(ValueError, match="multiple of the chunk"):
            LS.wkv(*t, torch.from_numpy(u), chunk=chunk, impl=impl)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        LS.wkv_plain(*t, torch.from_numpy(u), chunk=chunk)


@pytest.mark.parametrize("impl", ["kernel", "chunked", "naive"])
def test_cpu_wkv_takes_plain_and_launches_nothing(impl):
    r, k, v, logw, u, s0 = inputs(2, 16, 2, 16, seed=4)
    t = [torch.from_numpy(x) for x in (r, k, v, logw, u)]
    before = LS.wkv_linear_scan.launches
    y, st = LS.wkv(*t, state0=torch.from_numpy(s0), chunk=8, impl=impl)
    want = LS.wkv_plain(*t, state0=torch.from_numpy(s0), chunk=8)
    assert torch.equal(y, want[0]) and torch.equal(st, want[1])
    assert LS.wkv_linear_scan.launches == before


def _good(b=1, s=4, h=2, kd=16):
    r, k, v, logw, u, s0 = inputs(b, s, h, kd)
    return dict(r=torch.from_numpy(r), k=torch.from_numpy(k),
                v=torch.from_numpy(v), logw=torch.from_numpy(logw),
                u=torch.from_numpy(u), state0=torch.from_numpy(s0))


BAD = {
    "cpu tensors": ({}, "one CUDA device"),
    "float16 r/k/v": ({n: "half" for n in "rkv"}, "all float32"),
    "mixed r/k/v": ({"v": "bfloat16"}, "all float32"),
    "bfloat16 logw": ({"logw": "bfloat16"}, "logw must be float32"),
    "bfloat16 u": ({"u": "bfloat16"}, "u must be float32"),
    "float64 state0": ({"state0": "double"}, "state0 must be float32"),
    "k shape": ({"k": "short"}, "one shape"),
    "u shape": ({"u": "short"}, r"u \[H,K\]"),
    "state0 shape": ({"state0": "short"}, "state0"),
    "K = 8": ({"*": "k8"}, "K in"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_raises_on_what_it_does_not_take(case):
    change, match = BAD[case]
    kw = _good(kd=8) if change.get("*") == "k8" else _good()
    for name, how in change.items():
        if name == "*":
            continue
        if how == "short":
            kw[name] = kw[name][..., :-1].contiguous()
        else:
            kw[name] = getattr(kw[name], how)()
    before = LS.wkv_linear_scan.launches
    with pytest.raises(RuntimeError, match=match):
        LS.wkv_linear_scan(**kw)
    assert LS.wkv_linear_scan.launches == before


WKV_TOL = {"float32": 1e-4, "bfloat16": BF16_STEP, "state": 1e-4}  # chip_smoke


def kernel_order(r, k, v, logw, u, s0, *, kq=4):
    """NumPy float32 step model of the CUDA kernel's arithmetic order at
    K=64: per step, ``r . S`` as ``kq`` partial sums over k-slices, added
    as the lanes' reduce-scatter adds them (``(p0 + p2) + (p1 + p3)``),
    then ``+ a_t * v`` with the bonus scalar ``a_t = sum_k r u k``; then
    ``S = w * S + k * v``, ``w = exp(logw)``."""
    b, s, h, kd = r.shape
    f32 = np.float32
    st = (np.zeros((b, h, kd, kd), f32) if s0 is None else s0.astype(f32))
    w = np.exp(logw).astype(f32)
    a = ((r * u) * k).sum(-1, dtype=f32)                  # [B, S, H]
    y = np.empty((b, s, h, kd), f32)
    sl = kd // kq
    for t in range(s):
        parts = [np.einsum("bhk,bhkv->bhv", r[:, t, :, q * sl:(q + 1) * sl],
                           st[:, :, q * sl:(q + 1) * sl]).astype(f32)
                 for q in range(kq)]
        while len(parts) > 1:
            half = len(parts) // 2
            parts = [parts[i] + parts[i + half] for i in range(half)]
        y[:, t] = parts[0] + a[:, t, :, None] * v[:, t]
        st = (w[:, t, :, :, None] * st
              + k[:, t, :, :, None] * v[:, t, :, None, :]).astype(f32)
    return y, st


@pytest.mark.parametrize("state", [False, True], ids=["zero", "state0"])
def test_kernel_order_fits_the_card_tolerance(jx, state):
    """The kernel's reordered sum (``kernel_order``) against the oracle
    ``wkv_ref`` and ``wkv_plain`` at S=1024, K=64, float32, on inputs drawn
    as ``chip_smoke.py`` draws them: within ``WKV_TOL``, the tolerance the
    card's check holds the kernel to."""
    jnp, _, wkv_ref = jx
    args = inputs(1, 1024, 2, 64, seed=7, state=state)
    y, st = kernel_order(*args)
    yr, str_ = jax_call(jnp, wkv_ref, *args, dtype=torch.float32)
    yp, stp = port(*args, chunk=64)
    assert np.isfinite(y).all() and np.isfinite(st).all()
    for want_y, want_st in ((yr, str_), (yp, stp)):
        assert share(y, want_y) <= WKV_TOL["float32"]
        assert share(st, want_st) <= WKV_TOL["state"]


def _plain_chunk(s):
    """The largest chunk <= 64 dividing s (``chip_smoke.plain_chunk``)."""
    return max(c for c in range(1, 65) if s % c == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 1, 1, 16), (2, 64, 3, 32),
                                   (2, 1000, 4, 64), (2, 1, 4, 64),
                                   (1, 31, 3, 16), (3, 32, 1, 32),
                                   (1, 33, 5, 64), (1, 1024, 3, 64),
                                   (3, 1000, 1, 16), (1, 1024, 5, 32)],
                         ids=lambda s: "-".join(map(str, s)))
def test_cuda_kernel_matches_plain(shape, dtype):
    """The kernel against ``wkv_plain`` (chunk: the largest <= 64 dividing
    S) within 1e-4 of max |.| in float32 (``expf`` products against
    ``exp`` of cumulative-sum differences) and one bfloat16 step of max |y|
    in bfloat16, from a zero and a random state; every K, S around the
    32-step chunk and ragged, B*H odd; two calls bit-equal, one launch
    each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    b, s, h, kd = shape
    for state in (False, True):
        r, k, v, logw, u, s0 = (None if x is None else
                                torch.from_numpy(x).cuda()
                                for x in inputs(b, s, h, kd, seed=5,
                                                state=state))
        r, k, v = r.to(dt), k.to(dt), v.to(dt)
        before = LS.wkv_linear_scan.launches
        y, st = LS.wkv_linear_scan(r, k, v, logw, u, state0=s0)
        y2, st2 = LS.wkv_linear_scan(r, k, v, logw, u, state0=s0)
        torch.cuda.synchronize()
        assert LS.wkv_linear_scan.launches == before + 2
        assert torch.equal(y, y2) and torch.equal(st, st2)
        yw, stw = LS.wkv_plain(r, k, v, logw, u, state0=s0,
                               chunk=_plain_chunk(s))
        tol = 1e-4 if dt == torch.float32 else BF16_STEP
        assert y.dtype == dt and st.dtype == torch.float32
        assert share(y.float().cpu(), yw.float().cpu()) <= tol
        assert share(st.cpu(), stw.cpu()) <= 1e-4


@pytest.mark.cuda
def test_cuda_misaligned_views_are_copied():
    """Contiguous views off a 16-byte boundary (a storage offset of one
    element) give the aligned inputs' result, in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = [torch.from_numpy(x).cuda()
            for x in inputs(2, 40, 3, 32, seed=6)]
    want = LS.wkv_linear_scan(*args[:5], state0=args[5])

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    before = LS.wkv_linear_scan.launches
    got = LS.wkv_linear_scan(*map(shifted, args[:5]),
                             state0=shifted(args[5]))
    torch.cuda.synchronize()
    assert LS.wkv_linear_scan.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
