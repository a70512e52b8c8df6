"""The port's VLM family (``models/transformer.py`` with M-RoPE and the stub
patch-embedding frontend) against the JAX package, on the reduced
``qwen2-vl-72b`` (2 layers, d_model 64, 4 q / 2 kv heads of 16, M-RoPE
sections (2, 3, 3), 16 patch embeddings), float32, sharding off, with the
JAX model's parameters carried over by ``convert.model_params_from_numpy``.

With default positions all three M-RoPE streams carry one id, and M-RoPE
is RoPE whatever the section split, so these tests pass explicit
``positions [3, B, S]`` whose streams differ: the 16 patches lie on a 4 x 4
grid (t = 0, h = i // 4, w = i % 4) and the text continues from the
largest id plus one in all three streams, as Qwen2-VL numbers them.

Held: ``forward`` at each attention impl; a prefill plus 4 teacher-forced
decode steps and the greedy tokens of ``generate``; a decode step with
``extra_embeds``; ``loss_fn`` (labels on the text tail) and its gradients
against ``jax.value_and_grad``; and ``make_batch``'s patch / text split
against the JAX package's.

Tolerances: logits within 1e-5 of their max |logit| (float32 sums in
another order than XLA's), greedy tokens identical; the loss within 1e-5
relative, each gradient leaf within 1e-4 of its max |g| (the backward sums
in another order; ``test_torch_moe.py`` holds the MoE gradients the same
way).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402
from repro_torch.models.registry import make_batch as t_make_batch  # noqa
from repro_torch.tree import tree_items  # noqa: E402

ARCH = "qwen2-vl-72b"
B, P, S_TEXT, STEPS = 2, 16, 12, 4
S = P + S_TEXT
LOGIT_TOL, LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5, 1e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces, with any mesh a test before left active
    switched off (``launch/steps.py`` activates one)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import registry as JR
    from repro.models import transformer as JT
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    return dict(jax=jax, jnp=jnp, cfg=get_config(ARCH).reduced(), JR=JR,
                JT=JT)


@pytest.fixture(scope="module")
def tree(jx):
    jax = jx["jax"]
    return jax.tree_util.tree_map(np.asarray, jx["JR"].build_model(
        jx["cfg"]).init_params(jax.random.PRNGKey(5)))


def port(impl="chunked"):
    return dataclasses.replace(t_get_config(ARCH).reduced(),
                               attention_impl=impl)


def grid_positions() -> np.ndarray:
    """``[3, B, S]`` M-RoPE ids: patches on a 4 x 4 grid, then the text
    from the largest id plus one in all three streams."""
    side = int(P ** 0.5)
    i = np.arange(P)
    patch = np.stack([np.zeros(P), i // side, i % side])
    start = patch.max() + 1
    text = np.broadcast_to(start + np.arange(S_TEXT), (3, S_TEXT))
    pos = np.concatenate([patch, text], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B, S)))


def inputs(seed, vocab, d=64):
    """tokens ``[B, S_TEXT + STEPS]``, patch embeddings ``[B, P, d]`` and
    labels ``[B, S_TEXT]`` (one masked), from one seeded generator."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S_TEXT + STEPS), dtype=np.int32)
    patches = rng.standard_normal((B, P, d)).astype(np.float32)
    labels = rng.integers(0, vocab, (B, S_TEXT), dtype=np.int32)
    labels[1, 2] = -1
    return toks, patches, labels


def share(got, want):
    """max |got - want| as a share of max |want|."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def both_batches(jx, toks, patches, labels=None):
    jnp = jx["jnp"]
    pos = grid_positions()
    nb = {"tokens": toks[:, :S_TEXT], "patch_embeds": patches,
          "positions": pos}
    if labels is not None:
        nb["labels"] = labels
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in nb.items()})


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
def test_forward_matches_jax(jx, tree, impl):
    """Logits over patches and text; default positions (M-RoPE equal to
    RoPE) give other logits, so the three streams are read."""
    jax, jnp = jx["jax"], jx["jnp"]
    cfg = port(impl)
    toks, patches, _ = inputs(1, cfg.vocab_size)
    jb, tb = both_batches(jx, toks, patches)
    want, _ = jx["JR"].build_model(jx["cfg"]).forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jb)
    params = convert.model_params_from_numpy(cfg, tree, device="cpu")
    with torch.no_grad():
        got = TT.forward(params, tb, cfg)
        plain = TT.forward(params, {k: v for k, v in tb.items()
                                    if k != "positions"}, cfg)
    assert got.shape == (B, S, cfg.padded_vocab)
    assert share(got, want) <= LOGIT_TOL
    assert share(plain, want) > 1e-3


def jax_serve(jx, tree, toks, jb):
    """The JAX prefill + STEPS teacher-forced decode logits, and its greedy
    tokens from the prompt."""
    jax, jnp = jx["jax"], jx["jnp"]
    m = jx["JR"].build_model(jx["cfg"])
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    prefill, decode = jax.jit(m.prefill), jax.jit(m.decode_step)
    logits, cache = prefill(params, jb, m.init_cache(B, S + STEPS + 4))
    steps = [np.asarray(logits[:, 0])]
    for t in range(STEPS):
        logits, cache = decode(params, toks[:, S_TEXT + t:S_TEXT + t + 1],
                               cache)
        steps.append(np.asarray(logits[:, 0]))
    logits, cache = prefill(params, jb, m.init_cache(B, S + STEPS + 4))
    tok = np.asarray(logits[:, -1]).argmax(-1)[:, None].astype(np.int32)
    greedy = [tok]
    for _ in range(STEPS):
        logits, cache = decode(params, tok, cache)
        tok = np.asarray(logits[:, -1]).argmax(-1)[:, None].astype(np.int32)
        greedy.append(tok)
    return np.stack(steps), np.concatenate(greedy, 1)


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_prefill_decode_and_greedy_match_jax(jx, tree, impl):
    from repro_torch.launch.serve import generate
    cfg = port(impl)
    toks, patches, _ = inputs(2, cfg.vocab_size)
    jb, tb = both_batches(jx, toks, patches)
    want, greedy = jax_serve(jx, tree, toks, jb)
    m = t_build(cfg)
    params = convert.model_params_from_numpy(cfg, tree, device="cpu")
    t = torch.from_numpy(toks)
    cache = m.init_cache(B, S + STEPS + 4, device="cpu")
    with torch.no_grad():
        logits, cache = m.prefill(params, tb, cache)
        assert cache.length == S
        got = [logits[:, 0]]
        for i in range(STEPS):
            logits, cache = m.decode_step(
                params, t[:, S_TEXT + i:S_TEXT + i + 1], cache)
            got.append(logits[:, 0])
    assert share(torch.stack(got), want) <= LOGIT_TOL
    out = generate(m, params, tb, m.init_cache(B, S + STEPS + 4,
                                               device="cpu"), gen=STEPS)
    np.testing.assert_array_equal(out["tokens"], greedy)
    assert out["cache_len"] == S + STEPS


def test_decode_step_extra_embeds_matches_jax(jx, tree):
    """``extra_embeds`` (the per-step frontend hook) added to each decode
    step's token embedding, against the JAX ``decode_step``; without them
    the logits differ."""
    jax, jnp = jx["jax"], jx["jnp"]
    cfg = port()
    toks, patches, _ = inputs(3, cfg.vocab_size)
    extra = np.random.default_rng(4).standard_normal(
        (STEPS, B, 1, cfg.d_model)).astype(np.float32)
    jb, tb = both_batches(jx, toks, patches)
    jm = jx["JR"].build_model(jx["cfg"])
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    _, jcache = jm.prefill(jparams, jb, jm.init_cache(B, S + STEPS))
    params = convert.model_params_from_numpy(cfg, tree, device="cpu")
    with torch.no_grad():
        _, cache = TT.prefill(params, tb, cfg,
                              TT.init_cache(cfg, B, S + STEPS, device="cpu"))
        for i in range(STEPS):
            tok = toks[:, S_TEXT + i:S_TEXT + i + 1]
            jl, jcache = jx["JT"].decode_step(
                jparams, jnp.asarray(tok), jx["cfg"], jcache,
                extra_embeds=jnp.asarray(extra[i]))
            copy = dataclasses.replace(cache, k=cache.k.clone(),
                                       v=cache.v.clone())
            got, cache = TT.decode_step(params, torch.from_numpy(tok), cfg,
                                        cache, extra_embeds=torch.from_numpy(
                                            extra[i]))
            assert share(got, jl) <= LOGIT_TOL
            bare, _ = TT.decode_step(params, torch.from_numpy(tok), cfg, copy)
            assert share(bare, jl) > 1e-3


def test_loss_and_grads_match_jax(jx, tree):
    """``loss_fn`` (labels on the text tail, one masked) and its gradients
    against ``jax.value_and_grad`` under the config's full remat."""
    jax, jnp = jx["jax"], jx["jnp"]
    cfg = port()
    assert cfg.remat == "full"
    toks, patches, labels = inputs(6, cfg.vocab_size)
    jb, tb = both_batches(jx, toks, patches, labels)
    jloss, jgrads = jax.value_and_grad(jx["JR"].build_model(
        jx["cfg"]).loss_fn)(jax.tree_util.tree_map(jnp.asarray, tree), jb)
    params = convert.model_params_from_numpy(cfg, tree, device="cpu")
    for _, v in tree_items(params):
        v.requires_grad_(True)
    loss = t_build(cfg).loss_fn(params, tb)
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, jgrads)))
    got = {k: v.grad.numpy() for k, v in tree_items(params)}
    assert sorted(got) == sorted(want)
    for k in want:
        assert share(got[k], want[k]) <= GRAD_TOL, k


@pytest.mark.parametrize("s,train", [(40, True), (40, False), (8, True)])
def test_make_batch_splits_patches_and_text(jx, s, train):
    """``make_batch`` gives the JAX package's keys, shapes and dtypes: the
    first ``frontend_tokens`` positions as 0.02-scale patch embeddings in
    the compute dtype, the tokens (and labels) on the rest (at least one);
    a dense config gets tokens alone."""
    cfg = dataclasses.replace(t_get_config(ARCH).reduced(),
                              compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jx["cfg"], compute_dtype="bfloat16")
    want = jx["JR"].make_batch(jcfg, B, s, train=train,
                               key=jx["jax"].random.PRNGKey(0))
    got = t_make_batch(cfg, B, s, generator=torch.Generator().manual_seed(0),
                       device="cpu", train=train)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert got["tokens"].shape[1] == max(1, s - P)
    assert abs(float(got["patch_embeds"].float().std()) - 0.02) < 2e-3
    dense = t_make_batch(t_get_config("qwen3-1.7b").reduced(), B, s,
                         generator=torch.Generator(), device="cpu")
    assert set(dense) == {"tokens"} and dense["tokens"].shape == (B, s)
