"""The port's Mamba2 (SSD) mixer against the JAX package's
``models/mamba2.py``, on the reduced ``zamba2-7b`` layer (d_model 64,
d_inner 128, 8 heads of 16, state 16, conv 4), float32, with the JAX
layer's own parameters carried over and the same seeded NumPy inputs.

Held: ``ssd_chunked`` over several chunks (chunk 16, S 64) from a nonzero
``h0`` and with one chunk, ``_causal_conv`` with a carried tail,
``mamba2_forward`` from a nonzero state and ``mamba2_decode_step`` against
JAX's, and inside the port, a forward over S against the same S tokens
stepped one at a time by ``mamba2_decode_step`` (the state carry).

Tolerances: outputs and states within 1e-5 of their max |.| (float32 sums
in another order than XLA's, through exp of cumulative sums); the conv
(four products and adds in the JAX order) within 1e-6 absolute.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import mamba2 as TM2  # noqa: E402

B = 2
TOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX package's mamba2 module and reduced config, with any mesh a
    test before left active switched off."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import mamba2 as JM2
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    return jax, jnp, JM2, get_config("zamba2-7b").reduced()


@pytest.fixture(scope="module")
def layer(jx):
    """One JAX ``init_mamba2`` layer (float32) as NumPy, with ``A_log``,
    ``D``, ``dt_bias`` and ``norm_scale`` redrawn off their constants, and
    the port's copy."""
    jax, jnp, JM2, cfg = jx
    p = {k: np.asarray(v) for k, v in JM2.init_mamba2(
        jax.random.PRNGKey(3), cfg, jnp.float32).items()}
    rng = np.random.default_rng(3)
    for k in ("A_log", "D", "dt_bias", "norm_scale"):
        p[k] = (p[k] + 0.3 * rng.standard_normal(p[k].shape)).astype(
            np.float32)
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def share(got, want):
    """max |got - want| as a share of max |want|."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def ssd_inputs(s, h=8, p=16, n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, s, h)))).astype(np.float32)
    Bm = rng.standard_normal((B, s, n)).astype(np.float32)
    C = rng.standard_normal((B, s, n)).astype(np.float32)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    h0 = rng.standard_normal((B, h, p, n)).astype(np.float32)
    return x, dt, Bm, C, A, D, h0


@pytest.mark.parametrize("s,chunk,with_h0", [(64, 16, True), (64, 16, False),
                                             (32, 128, True)])
def test_ssd_chunked_matches_jax(jx, s, chunk, with_h0):
    """Four chunks carry the state (from a nonzero ``h0``, and from zero);
    one chunk when ``chunk`` exceeds S."""
    _, jnp, JM2, _ = jx
    x, dt, Bm, C, A, D, h0 = ssd_inputs(s, seed=s + chunk)
    args = [x, dt, Bm, C, A, D]
    y, hf = TM2.ssd_chunked(*(torch.from_numpy(a) for a in args),
                            chunk=chunk,
                            h0=torch.from_numpy(h0) if with_h0 else None)
    jy, jhf = JM2.ssd_chunked(*(jnp.asarray(a) for a in args), chunk=chunk,
                              h0=jnp.asarray(h0) if with_h0 else None)
    assert y.dtype == torch.float32 and hf.dtype == torch.float32
    assert share(y, jy) <= TOL
    assert share(hf, jhf) <= TOL


def test_ssd_chunked_refuses_a_ragged_chunk():
    x, dt, Bm, C, A, D, _ = ssd_inputs(40)
    with pytest.raises(AssertionError):
        TM2.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, Bm, C, A, D)),
                        chunk=16)


def test_ssd_chunked_remat_gradients_are_finite():
    """Under remat the chunk bodies recompute in the backward pass; the
    masked exponent keeps every gradient finite and equal to the plain
    backward's."""
    arrays = ssd_inputs(64, seed=5)
    grads = []
    for remat in (False, True):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        y, hf = TM2.ssd_chunked(*ts[:6], chunk=16, h0=ts[6], remat=remat)
        (y.square().sum() + hf.sum()).backward()
        grads.append([t.grad for t in ts])
    for g, g_remat in zip(*grads):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g_remat, g, rtol=0, atol=0)


def test_causal_conv_with_carried_tail(jx):
    _, jnp, JM2, _ = jx
    x, w, b, prev = (rand(B, 10, 160), rand(4, 160, seed=1, scale=0.25),
                     rand(160, seed=2), rand(B, 3, 160, seed=3))
    for p in (prev, None):
        y, tail = TM2._causal_conv(
            *(torch.from_numpy(a) for a in (x, w, b)),
            None if p is None else torch.from_numpy(p))
        jy, jtail = JM2._causal_conv(
            *(jnp.asarray(a) for a in (x, w, b)),
            None if p is None else jnp.asarray(p))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


def state_of(seed, cfg):
    d_inner = cfg.d_model * cfg.ssm_expand
    h = d_inner // cfg.ssm_headdim
    return (rand(B, h, cfg.ssm_headdim, cfg.ssm_state, seed=seed, scale=0.5),
            rand(B, cfg.ssm_conv - 1, d_inner + 2 * cfg.ssm_state,
                 seed=seed + 1))


@pytest.mark.parametrize("with_state", [True, False])
def test_forward_matches_jax(jx, layer, with_state):
    jax, jnp, JM2, jcfg = jx
    p, tp = layer
    cfg = t_get_config("zamba2-7b").reduced()
    h = rand(B, 32, cfg.d_model, seed=6)
    ssm, conv = state_of(7, cfg)
    st = TM2.Mamba2State(torch.from_numpy(ssm), torch.from_numpy(conv)) \
        if with_state else None
    jst = JM2.Mamba2State(jnp.asarray(ssm), jnp.asarray(conv)) \
        if with_state else None
    out, new = TM2.mamba2_forward(tp, torch.from_numpy(h), cfg, state=st,
                                  chunk=8)
    jout, jnew = JM2.mamba2_forward({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(h), jcfg, state=jst, chunk=8)
    assert share(out, jout) <= TOL
    assert share(new.ssm, jnew.ssm) <= TOL
    assert share(new.conv, jnew.conv) <= TOL


def test_decode_step_matches_jax(jx, layer):
    jax, jnp, JM2, jcfg = jx
    p, tp = layer
    cfg = t_get_config("zamba2-7b").reduced()
    ssm, conv = state_of(9, cfg)
    st = TM2.Mamba2State(torch.from_numpy(ssm), torch.from_numpy(conv))
    jst = JM2.Mamba2State(jnp.asarray(ssm), jnp.asarray(conv))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for t in range(3):
        h = rand(B, 1, cfg.d_model, seed=10 + t)
        out, st = TM2.mamba2_decode_step(tp, torch.from_numpy(h), cfg, st)
        jout, jst = JM2.mamba2_decode_step(jp, jnp.asarray(h), jcfg, jst)
        assert share(out, jout) <= TOL
        assert share(st.ssm, jst.ssm) <= TOL
        np.testing.assert_allclose(st.conv.numpy(), np.asarray(jst.conv),
                                   rtol=0, atol=1e-6)


def test_forward_equals_token_by_token_decode(layer):
    """A forward over S from a state gives the outputs and final state of
    the same S tokens stepped one at a time from that state (the port
    alone: the chunked scan against the recurrence)."""
    _, tp = layer
    cfg = t_get_config("zamba2-7b").reduced()
    h = torch.from_numpy(rand(B, 16, cfg.d_model, seed=12))
    ssm, conv = state_of(13, cfg)
    st0 = TM2.Mamba2State(torch.from_numpy(ssm), torch.from_numpy(conv))
    out, final = TM2.mamba2_forward(tp, h, cfg, state=st0, chunk=4)
    st, steps = st0, []
    for t in range(h.shape[1]):
        o, st = TM2.mamba2_decode_step(tp, h[:, t:t + 1], cfg, st)
        steps.append(o)
    assert share(torch.cat(steps, 1), out.numpy()) <= TOL
    assert share(st.ssm, final.ssm.numpy()) <= TOL
    # the conv tail holds in_proj outputs: one row's product against the
    # sequence's, summed in another order
    torch.testing.assert_close(st.conv, final.conv, rtol=0, atol=1e-6)


def test_init_matches_the_recipe(jx):
    """Keys, shapes and dtypes of one layer against JAX's ``init_mamba2``
    in bfloat16 (``A_log``, ``D``, ``dt_bias`` and ``norm_scale`` float32 in
    both), with the JAX constants."""
    jax, jnp, JM2, jcfg = jx
    cfg = t_get_config("zamba2-7b").reduced()
    want = JM2.init_mamba2(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    got = TM2.init_mamba2(torch.Generator().manual_seed(0), cfg,
                          torch.bfloat16, lead=(3,))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == (3, *w.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
        if k in ("A_log", "D", "dt_bias", "norm_scale", "conv_b"):
            np.testing.assert_allclose(got[k][1].float().numpy(),
                                       np.asarray(w, np.float32), rtol=1e-6)
    assert TM2.mamba2_shapes(cfg, (3,)) == {k: tuple(v.shape)
                                            for k, v in got.items()}
