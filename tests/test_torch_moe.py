"""The port's MoE family against the JAX package, on the reduced
``moonshot-v1-16b-a3b`` (8 experts, top-2, one shared expert) and
``phi3.5-moe-42b-a6.6b`` (8 experts, top-2, none shared): 2 layers,
d_model 64, float32, with the JAX model's own parameters carried over by
``convert.model_params_from_numpy`` and sharding off.

Held: ``moe_ffn`` (the top-k expert indices identical, ``y`` within 1e-5 of
max |y|, ``aux`` within 1e-6 relative), a forced overflow where every token
ranks expert 0 first (the kept slots identical to the dispatch's rule --
each expert keeps its earliest ``cap`` assignments -- and ``y`` matching
JAX, which drops the same ones), one token (capacity 1), the parameter
tree's keys, shapes and dtypes against JAX's ``init_params`` (router in
float32), the whole model's prefill plus 4 decode steps (logits within 1e-5
of max |logit|, greedy tokens identical) and ``loss_fn`` with its gradients
against ``jax.value_and_grad`` (the loss within 1e-5 relative, each
gradient leaf within 1e-4 of its max |g|, as ``test_torch_train.py`` holds
the dense family's).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]
B, S, STEPS = 2, 16, 4
Y_TOL, AUX_RTOL, LOGIT_TOL = 1e-5, 1e-6, 1e-5
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX package's model pieces, with any mesh a test before left
    active switched off (``launch/steps.py`` activates one)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import moe as JM
    from repro.models.registry import build_model
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    return dict(jax=jax, jnp=jnp, get_config=get_config, JM=JM,
                build_model=build_model)


@pytest.fixture(scope="module")
def trees(jx):
    """arch -> the reduced JAX model's ``init_params`` tree as NumPy."""
    jax = jx["jax"]
    return {arch: jax.tree_util.tree_map(np.asarray, jx["build_model"](
        jx["get_config"](arch).reduced()).init_params(jax.random.PRNGKey(1)))
        for arch in ARCHS}


def port_params(arch, tree):
    cfg = t_get_config(arch).reduced()
    return cfg, convert.model_params_from_numpy(cfg, tree, device="cpu")


def layer0_moe(tree):
    """Layer 0's MoE parameters of a stacked tree (NumPy or torch)."""
    def take(node):
        return ({k: take(v) for k, v in node.items()}
                if isinstance(node, dict) else node[0])
    return take(tree["layers"]["moe"])


def share(got, want):
    """max |got - want| as a share of max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def jax_experts(jx, p, x, cfg):
    """The JAX routing's top-k expert indices, as ``moe_ffn`` computes
    them."""
    jax, jnp = jx["jax"], jx["jnp"]
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), p["router"])
    _, experts = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                               cfg.num_experts_per_token)
    return np.asarray(experts)


def both_moe(jx, arch, tree, x):
    """``moe_ffn`` of both packages on layer 0's parameters of ``tree``:
    (port y, port aux, port experts, JAX y, JAX aux, JAX experts)."""
    jnp = jx["jnp"]
    jcfg = jx["get_config"](arch).reduced()
    cfg, params = port_params(arch, tree)
    jp = jx["jax"].tree_util.tree_map(jnp.asarray, layer0_moe(tree))
    tp = layer0_moe(params)
    with torch.no_grad():
        y, aux = TM.moe_ffn(tp, torch.from_numpy(x), cfg)
        _, _, experts = TM.route(tp, torch.from_numpy(x), cfg)
    jy, jaux = jx["JM"].moe_ffn(jp, jnp.asarray(x), jcfg)
    return (y.numpy(), float(aux), experts.numpy(), np.asarray(jy),
            float(jaux), jax_experts(jx, jp, x, jcfg))


def x_of(seed, s, d=64):
    return np.random.default_rng(seed).standard_normal(
        (B, s, d), dtype=np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(jx, trees, arch):
    y, aux, experts, jy, jaux, jexperts = both_moe(jx, arch, trees[arch],
                                                   x_of(0, S))
    np.testing.assert_array_equal(experts, jexperts)
    assert share(y, jy) <= Y_TOL
    assert abs(aux - jaux) <= AUX_RTOL * abs(jaux)
    assert aux.__class__ is float and np.isfinite(aux)


def expected_keep(experts: np.ndarray, num_experts: int, cap: int):
    """The dispatch's rule in NumPy, by token order: each expert keeps its
    first ``cap`` assignments (flattened ``(token, k)`` order), the rest go
    to the sentinel.  -> (slot, keep) per flattened assignment."""
    b = experts.shape[0]
    flat = experts.reshape(b, -1)
    slot = np.full(flat.shape, num_experts * cap)
    for r in range(b):
        seen = np.zeros(num_experts, int)
        for i, e in enumerate(flat[r]):
            if seen[e] < cap:
                slot[r, i] = e * cap + seen[e]
            seen[e] += 1
    return slot, slot < num_experts * cap


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_overflow_drops_the_later_tokens(jx, trees, arch):
    """Every token ranks expert 0 first (positive inputs, a large positive
    router column 0), so expert 0 gets all S assignments a row and keeps
    its first ``cap``."""
    tree = {**trees[arch], "layers": dict(trees[arch]["layers"])}
    moe = dict(tree["layers"]["moe"])
    router = moe["router"].copy()
    router[:, :, 0] = 4.0 / np.sqrt(router.shape[1])
    moe["router"] = router
    tree["layers"]["moe"] = moe
    x = x_of(1, S) + 1.0
    y, aux, experts, jy, jaux, jexperts = both_moe(jx, arch, tree, x)
    np.testing.assert_array_equal(experts, jexperts)
    assert (experts[..., 0] == 0).all()
    cfg = t_get_config(arch).reduced()
    cap = TM.capacity(S, cfg)
    assert cap < S                            # expert 0 overflows
    order, slot, keep = TM.dispatch(torch.from_numpy(experts),
                                    cfg.num_experts, cap)
    want_slot, want_keep = expected_keep(experts, cfg.num_experts, cap)
    inv = np.argsort(order.numpy(), axis=-1)  # back to (token, k) order
    np.testing.assert_array_equal(
        np.take_along_axis(slot.numpy(), inv, -1), want_slot)
    np.testing.assert_array_equal(
        np.take_along_axis(keep.numpy(), inv, -1), want_keep)
    assert int(want_keep[:, ::cfg.num_experts_per_token].sum()) == B * cap
    assert share(y, jy) <= Y_TOL
    assert abs(aux - jaux) <= AUX_RTOL * abs(jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_token_has_capacity_one(jx, trees, arch):
    assert TM.capacity(1, t_get_config(arch).reduced()) == 1
    y, aux, experts, jy, jaux, jexperts = both_moe(jx, arch, trees[arch],
                                                   x_of(2, 1))
    np.testing.assert_array_equal(experts, jexperts)
    assert share(y, jy) <= Y_TOL
    assert abs(aux - jaux) <= AUX_RTOL * abs(jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(jx, arch):
    """Keys, shapes and dtypes of both packages' ``init_params`` in
    bfloat16, the router float32 in both; the JAX tree converts with its
    dtypes kept."""
    jax = jx["jax"]
    jcfg = dataclasses.replace(jx["get_config"](arch).reduced(),
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(t_get_config(arch).reduced(),
                               param_dtype="bfloat16")
    jtree = jx["build_model"](jcfg).init_params(jax.random.PRNGKey(0))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in tree_items(
        jax.tree_util.tree_map(np.asarray, jtree))}
    params = t_build(tcfg).init_params(torch.Generator().manual_seed(0),
                                       device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in tree_items(params)}
    assert got == want
    assert got["layers/moe/router"][1] == "float32"
    assert got["layers/moe/w_gate"][1] == "bfloat16"
    assert ("layers/moe/shared/w_gate" in got) == (arch == ARCHS[0])
    conv = convert.model_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jtree), device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tree_items(conv)} == want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_the_recipe(arch):
    """The port's MoE init: experts of one layer share one base draw (their
    pairwise differences are the 0.02 noise), the router at 1/sqrt(d)."""
    cfg = t_get_config(arch).reduced()
    p = TM.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32,
                    device="cpu", lead=(cfg.num_layers,))
    w = p["w_up"]
    assert w.shape == (cfg.num_layers, cfg.num_experts, cfg.d_model,
                       cfg.d_ff)
    diff = (w[:, 1:] - w[:, :1]).std().item()
    assert abs(diff - 0.02 * 2 ** 0.5) < 2e-3
    assert abs(w.std().item() - cfg.d_model ** -0.5) < 2e-2
    assert abs(p["router"].std().item() - cfg.d_model ** -0.5) < 2e-2
    assert not torch.equal(w[0], w[1])       # layers drawn apart


def jax_serve(jx, arch, tree, toks):
    """The reduced JAX model's prefill + STEPS teacher-forced decode
    logits, and its greedy tokens from the prompt."""
    jax = jx["jax"]
    m = jx["build_model"](jx["get_config"](arch).reduced())
    params = jax.tree_util.tree_map(jx["jnp"].asarray, tree)
    prefill, decode = jax.jit(m.prefill), jax.jit(m.decode_step)
    logits, cache = prefill(params, {"tokens": toks[:, :S]},
                            m.init_cache(B, S + STEPS + 4))
    steps = [np.asarray(logits[:, 0])]
    for t in range(STEPS):
        logits, cache = decode(params, toks[:, S + t:S + t + 1], cache)
        steps.append(np.asarray(logits[:, 0]))
    logits, cache = prefill(params, {"tokens": toks[:, :S]},
                            m.init_cache(B, S + STEPS + 4))
    tok = np.asarray(logits[:, -1]).argmax(-1)[:, None].astype(np.int32)
    greedy = [tok]
    for _ in range(STEPS):
        logits, cache = decode(params, tok, cache)
        tok = np.asarray(logits[:, -1]).argmax(-1)[:, None].astype(np.int32)
        greedy.append(tok)
    return np.stack(steps), np.concatenate(greedy, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_greedy_match_jax(jx, trees, arch):
    from repro_torch.launch.serve import generate
    cfg, params = port_params(arch, trees[arch])
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S + STEPS), dtype=np.int32)
    want, greedy = jax_serve(jx, arch, trees[arch], toks)
    m = t_build(cfg)
    t = torch.from_numpy(toks)
    cache = m.init_cache(B, S + STEPS + 4, device="cpu")
    with torch.no_grad():
        logits, cache = m.prefill(params, {"tokens": t[:, :S]}, cache)
        got = [logits[:, 0]]
        for i in range(STEPS):
            logits, cache = m.decode_step(params, t[:, S + i:S + i + 1],
                                          cache)
            got.append(logits[:, 0])
    assert share(torch.stack(got).numpy(), want) <= LOGIT_TOL
    out = generate(m, params, {"tokens": t[:, :S]},
                   m.init_cache(B, S + STEPS + 4, device="cpu"), gen=STEPS)
    np.testing.assert_array_equal(out["tokens"], greedy)


@pytest.mark.parametrize("arch,remat", [(a, "full") for a in ARCHS]
                         + [(ARCHS[0], "dots")],
                         ids=ARCHS + [f"{ARCHS[0]}-dots"])
def test_loss_and_grads_match_jax(jx, trees, arch, remat):
    """``loss_fn`` (cross-entropy plus ``router_aux_coef`` times the
    layers' summed aux) and its gradients against ``jax.value_and_grad``,
    under the config's full remat, and for moonshot also under ``"dots"``
    (the router's and shared experts' products saved, the experts'
    batched ones recomputed, on both sides)."""
    jax, jnp = jx["jax"], jx["jnp"]
    tree = trees[arch]
    rng = np.random.default_rng(4)
    cfg, params = port_params(arch, tree)
    cfg = dataclasses.replace(cfg, remat=remat)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
             for k in ("tokens", "labels")}
    jm = jx["build_model"](dataclasses.replace(
        jx["get_config"](arch).reduced(), remat=remat))
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    for _, v in tree_items(params):
        v.requires_grad_(True)
    loss = t_build(cfg).loss_fn(params, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, jgrads)))
    got = {k: v.grad.numpy() for k, v in tree_items(params)}
    assert sorted(got) == sorted(want)
    for k in want:
        assert share(got[k], want[k]) <= GRAD_TOL, k
