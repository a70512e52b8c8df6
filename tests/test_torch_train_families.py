"""Training every model family in the port: rwkv6's ``loss_fn`` on its
differentiable run, the training batch of each family as the JAX
``train`` builds it, and a few steps of every family through the training
step with the approximate collective's 8-bit round trip.

Held against the JAX package (reduced configs, float32, sharding off):
``rwkv6.loss_fn`` and its gradients against ``jax.value_and_grad`` (``u``
and ``w0`` redrawn in the JAX tree first: the JAX init leaves both idle),
within 1e-5 relative and 1e-4 of each leaf's max |g|; the first loss of
the port's ``train()`` for ``qwen2-vl-72b`` and ``seamless-m4t-large-v2``
against the JAX ``loss_fn`` on the batch the JAX ``train`` builds
(``src/repro/launch/train.py``: zero patch embeddings for the VLM family,
``np.random.default_rng(step)`` frames for the audio family), with the
port's initial parameters carried across -- built by hand from the same
NumPy draws, since the JAX ``train`` itself cannot run on JAX 0.9 (its
``jax.make_mesh``), within 1e-5 relative.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.approx_comm import make_grad_compressor  # noqa: E402
from repro_torch.kernels import linear_scan as LS  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.launch.train import step_batch, train  # noqa: E402
from repro_torch.models import rwkv6 as TR  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402
from repro_torch.models.registry import make_batch as t_make_batch  # noqa
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa
from repro_torch.tree import tree_items, tree_map  # noqa: E402

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
FAMILY_ARCHS = ("seamless-m4t-large-v2", "rwkv6-1.6b", "moonshot-v1-16b-a3b",
                "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b", "zamba2-7b")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import registry as JR
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    return dict(jax=jax, jnp=jnp, get_config=get_config, JR=JR)


def share(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def rwkv_tree(jx):
    """The reduced rwkv6's JAX parameters (NumPy) with ``u`` and ``w0``
    redrawn, as ``tests/test_torch_rwkv6.py`` does."""
    jax = jx["jax"]
    cfg = jx["get_config"]("rwkv6-1.6b").reduced()
    tree = jax.tree_util.tree_map(np.asarray, jx["JR"].build_model(
        cfg).init_params(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(1)
    lay = tree["layers"]
    lay["u"] = (0.5 * rng.standard_normal(lay["u"].shape)).astype(np.float32)
    lay["w0"] = rng.uniform(-4.0, 0.0, lay["w0"].shape).astype(np.float32)
    return tree


def rwkv_batch(vocab, b=2, s=64):
    """tokens and labels ``[b, s]`` (two of the reduced 32-token chunks),
    one label masked."""
    rng = np.random.default_rng(2)
    toks = rng.integers(0, vocab, (b, s), dtype=np.int32)
    labels = rng.integers(0, vocab, (b, s), dtype=np.int32)
    labels[1, 5] = -1
    return {"tokens": toks, "labels": labels}


def port_params(cfg, tree):
    from repro_torch import convert
    params = convert.model_params_from_numpy(cfg, tree, device="cpu")
    for _, v in tree_items(params):
        v.requires_grad_(True)
    return params


def rwkv6_against_jax(jx, rwkv_tree, remat):
    """``rwkv6.loss_fn`` and its gradients against ``jax.value_and_grad``
    of the JAX ``loss_fn``, both configs under ``remat``."""
    jax, jnp = jx["jax"], jx["jnp"]
    jcfg = dataclasses.replace(jx["get_config"]("rwkv6-1.6b").reduced(),
                               remat=remat)
    cfg = dataclasses.replace(t_get_config("rwkv6-1.6b").reduced(),
                              remat=remat)
    nb = rwkv_batch(cfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(jx["JR"].build_model(jcfg).loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, rwkv_tree),
        {k: jnp.asarray(v) for k, v in nb.items()})
    params = port_params(cfg, rwkv_tree)
    loss = t_build(cfg).loss_fn(params, {k: torch.from_numpy(v)
                                         for k, v in nb.items()})
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, jgrads)))
    got = {k: v.grad.numpy() for k, v in tree_items(params)}
    assert sorted(got) == sorted(want)
    for k in want:
        assert share(got[k], want[k]) <= GRAD_TOL, k


def test_rwkv6_loss_and_grads_match_jax(jx, rwkv_tree):
    """Under the config's full remat."""
    assert t_get_config("rwkv6-1.6b").reduced().remat == "full"
    rwkv6_against_jax(jx, rwkv_tree, "full")


def test_rwkv6_loss_and_grads_match_jax_under_dots(jx, rwkv_tree):
    """Under ``"dots"``, which both packages run as ``"full"`` in this
    family."""
    rwkv6_against_jax(jx, rwkv_tree, "dots")


def test_rwkv6_remat_and_serving_state(rwkv_tree):
    """The checkpointed blocks give the plain run's gradients, and the
    serving pair keeps its in-place state update: ``prefill`` writes the
    new ``wkv`` states into the cache it is given and returns it."""
    base = t_get_config("rwkv6-1.6b").reduced()
    batch = {k: torch.from_numpy(v) for k, v in
             rwkv_batch(base.vocab_size).items()}
    grads = []
    for remat in ("full", "none"):
        cfg = dataclasses.replace(base, remat=remat)
        params = port_params(cfg, rwkv_tree)
        TR.loss_fn(params, batch, cfg).backward()
        grads.append({k: v.grad for k, v in tree_items(params)})
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=0,
                                   atol=1e-6)
    params = port_params(base, rwkv_tree)
    cache = TR.init_cache(base, 2, 0, device="cpu")
    with torch.no_grad():
        _, out = TR.prefill(params, {"tokens": batch["tokens"]}, base, cache)
    assert out.wkv is cache.wkv and bool(cache.wkv.abs().max() > 0)


def test_wkv_kernel_refuses_autograd():
    """``wkv(impl="kernel")`` has no backward: with an input that requires
    grad it raises (on the CPU too, rather than differentiating the plain
    version); without grad, or with another impl, it runs."""
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn((1, 8, 2, 16), generator=g) for _ in range(3))
    logw = -torch.rand((1, 8, 2, 16), generator=g)
    u = torch.randn((2, 16), generator=g).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        LS.wkv(r, k, v, logw, u, chunk=8, impl="kernel")
    y, _ = LS.wkv(r, k, v, logw, u, chunk=8, impl="chunked")
    y.sum().backward()
    assert u.grad is not None
    with torch.no_grad():
        y2, _ = LS.wkv(r, k, v, logw, u, chunk=8, impl="kernel")
    torch.testing.assert_close(y2, y.detach())


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "seamless-m4t-large-v2"])
def test_train_first_loss_matches_jax_batch(jx, arch):
    """The port's ``train()`` first loss against the JAX ``loss_fn`` on the
    batch the JAX ``train`` builds at step 0 -- the stream's tokens and
    labels plus zero patch embeddings (VLM) or ``default_rng(0)`` frames
    (audio) --, on the port's initial parameters.  For the VLM family the
    loss without the patch embeddings differs."""
    from repro.data.pipeline import TokenStream
    jax, jnp = jx["jax"], jx["jnp"]
    batch, seq = 2, 16
    cfg = dataclasses.replace(t_get_config(arch).reduced(),
                              train_microbatches=1)
    jcfg = dataclasses.replace(jx["get_config"](arch).reduced(),
                               train_microbatches=1)
    out = train(arch, steps=1, batch=batch, seq=seq, device="cpu")
    params = t_build(cfg).init_params(torch.Generator().manual_seed(0),
                                      device="cpu")
    jparams = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), params)
    raw = TokenStream(cfg.vocab_size, batch, seq, seed=0).next_batch()
    jb = {"tokens": jnp.asarray(raw["tokens"]),
          "labels": jnp.asarray(raw["labels"])}
    if cfg.family == "vlm":
        bare = float(jx["JR"].build_model(jcfg).loss_fn(jparams, jb))
        jb["patch_embeds"] = jnp.zeros(
            (batch, cfg.frontend_tokens, cfg.d_model), jnp.float32)
    else:
        jb["embeds"] = jnp.asarray(np.random.default_rng(0).normal(
            0, 0.02, (batch, seq, cfg.d_model)).astype(np.float32))
    want = float(jx["JR"].build_model(jcfg).loss_fn(jparams, jb))
    assert abs(out["first_loss"] - want) <= LOSS_RTOL * abs(want)
    if cfg.family == "vlm":
        assert abs(out["first_loss"] - bare) > 1e-3 * abs(want)
    got = step_batch(cfg, raw, 0, torch.device("cpu"))
    assert sorted(got) == sorted(jb)
    for k in jb:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jb[k]))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_trains(arch):
    """Every family through ``build_train_step`` with the 8-bit gradient
    round trip and attention ``"chunked"``, as the card's
    ``train_families`` phase runs them (reduced here, at the config's own
    microbatches): 4 AdamW steps on one repeated batch, finite and
    falling losses, every parameter moved."""
    cfg = t_get_config(arch).reduced()
    assert cfg.attention_impl == "chunked"
    g = torch.Generator().manual_seed(0)
    model = t_build(cfg)
    params = model.init_params(g, device="cpu")
    start = tree_map(torch.clone, params)
    state = init_opt_state(params, device="cpu")
    batch = t_make_batch(cfg, 4, 64, generator=g, device="cpu", train=True)
    step = build_train_step(cfg, AdamWConfig(learning_rate=3e-3,
                                             warmup_steps=1),
                            make_grad_compressor(8, min_size=1024))
    losses = []
    for _ in range(4):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    moved = [k for (k, a), (_, b) in zip(tree_items(params),
                                         tree_items(start))
             if not torch.equal(a, b)]
    assert len(moved) == len(tree_items(start))
