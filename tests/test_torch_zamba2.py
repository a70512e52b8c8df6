"""The port's hybrid family (``models/zamba2.py``) against the JAX package,
on the reduced ``zamba2-7b`` (d_model 64, 4 q / 2 kv heads of 16, Mamba2
state 16, LoRA rank 4, a shared block every 6 layers) at 12 layers (two
super-blocks, no leftover layer) and 14 (two super-blocks and two leftover
layers), float32, sharding off, with the JAX model's parameters carried
over by ``convert.model_params_from_numpy``.  The JAX init zeroes the
LoRA ``qb``/``kb``/``vb`` stacks, which would hide a wrong LoRA, so they
are redrawn nonzero on the NumPy side (with ``A_log``, ``D`` and
``dt_bias`` moved off their constants) before both packages get them.

Held: the parameter tree's keys, shapes and dtypes against JAX's
``init_params`` (bfloat16, the float32 leaves kept); ``forward``; a
prefill plus 4 teacher-forced decode steps at each attention impl and the
greedy tokens of ``generate``; ``loss_fn`` and its gradients against
``jax.value_and_grad`` under the config's full remat; decode from a JAX
cache carried across by ``convert.zamba_cache_from_numpy``; and the
refusal of a multi-token prompt on a non-empty cache.

Tolerances: logits within 1e-5 of their max |logit| (float32 sums in
another order than XLA's), greedy tokens identical; the loss within 1e-5
relative and each gradient leaf within 1e-4 of its max |g| (the backward
sums the layers' contributions in another order, through exp of
cumulative sums; up to 9e-6 seen here, so 1e-5 would leave no margin;
``test_torch_moe.py`` holds the MoE gradients the same way).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import zamba2 as TZ  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

LAYERS = [12, 14]
B, S, STEPS = 2, 16, 4
LOGIT_TOL, LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5, 1e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces, with any mesh a test before left active
    switched off (``launch/steps.py`` activates one)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models.registry import build_model
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    return dict(jax=jax, jnp=jnp, get_config=get_config,
                build_model=build_model)


def cfgs(jx, layers, **kw):
    """(JAX config, port config): reduced zamba2 at ``layers`` layers."""
    j = dataclasses.replace(jx["get_config"]("zamba2-7b").reduced(),
                            num_layers=layers, **kw)
    t = dataclasses.replace(t_get_config("zamba2-7b").reduced(),
                            num_layers=layers, **kw)
    return j, t


@pytest.fixture(scope="module")
def trees(jx):
    """layers -> the JAX ``init_params`` tree as NumPy, with the LoRA
    ``*b`` stacks redrawn nonzero and the Mamba2 constants moved."""
    jax = jx["jax"]
    out = {}
    for layers in LAYERS:
        jcfg, _ = cfgs(jx, layers)
        tree = jax.tree_util.tree_map(np.asarray, jx["build_model"](
            jcfg).init_params(jax.random.PRNGKey(layers)))
        rng = np.random.default_rng(layers)
        for k in ("qb", "kb", "vb"):
            a = tree["lora"][k]
            tree["lora"][k] = (0.2 * rng.standard_normal(a.shape)).astype(
                a.dtype)
        for k in ("A_log", "D", "dt_bias"):
            a = tree["mamba"][k]
            tree["mamba"][k] = (a + 0.3 * rng.standard_normal(a.shape)
                                ).astype(a.dtype)
        out[layers] = tree
    return out


def share(got, want):
    """max |got - want| as a share of max |want|."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def tokens(seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S + STEPS),
                                                dtype=np.int32)


def jax_serve(jx, jcfg, tree, toks):
    """The JAX model's prefill + STEPS teacher-forced decode logits, its
    greedy tokens from the prompt, and its cache after the prefill."""
    jax, jnp = jx["jax"], jx["jnp"]
    m = jx["build_model"](jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    prefill, decode = jax.jit(m.prefill), jax.jit(m.decode_step)
    logits, cache = prefill(params, {"tokens": toks[:, :S]},
                            m.init_cache(B, S + STEPS + 4))
    after_prefill = jax.tree_util.tree_map(np.asarray, cache)
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
    return np.stack(steps), np.concatenate(greedy, 1), after_prefill


@pytest.fixture(scope="module")
def served(jx, trees):
    """layers -> (tokens, JAX steps, JAX greedy, JAX cache after prefill),
    computed on first use."""
    runs = {}

    def run(layers):
        if layers not in runs:
            jcfg, tcfg = cfgs(jx, layers)
            toks = tokens(layers + 1, tcfg.vocab_size)
            runs[layers] = (toks, *jax_serve(jx, jcfg, trees[layers], toks))
        return runs[layers]

    return run


@pytest.mark.parametrize("layers", LAYERS)
def test_param_tree_matches_jax(jx, layers):
    """Keys, shapes and dtypes of both packages' ``init_params`` in
    bfloat16 (``A_log``, ``D``, ``dt_bias``, ``norm_scale`` and the norm
    scales float32 in both); the JAX tree converts with its dtypes kept."""
    jax = jx["jax"]
    jcfg, tcfg = cfgs(jx, layers, param_dtype="bfloat16")
    jtree = jx["build_model"](jcfg).init_params(jax.random.PRNGKey(0))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in tree_items(
        jax.tree_util.tree_map(np.asarray, jtree))}
    params = t_build(tcfg).init_params(torch.Generator().manual_seed(0),
                                       device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in tree_items(params)}
    assert got == want
    for k in ("mamba/A_log", "mamba/D", "mamba/dt_bias", "mamba/norm_scale",
              "mamba_norm/scale", "shared/attn_norm/scale"):
        assert got[k][1] == "float32", k
    assert got["lora/qa"][0] == (layers // 6, 64, 4)
    assert not params["lora"]["qb"].any()       # zero, as JAX's
    conv = convert.model_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jtree), device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tree_items(conv)} == want


@pytest.mark.parametrize("layers", LAYERS)
def test_forward_matches_jax(jx, trees, layers):
    jax, jnp = jx["jax"], jx["jnp"]
    jcfg, tcfg = cfgs(jx, layers)
    toks = tokens(layers + 2, tcfg.vocab_size)[:, :S]
    want, _ = jx["build_model"](jcfg).forward(
        jax.tree_util.tree_map(jnp.asarray, trees[layers]),
        {"tokens": jnp.asarray(toks)})
    params = convert.model_params_from_numpy(tcfg, trees[layers],
                                             device="cpu")
    with torch.no_grad():
        got = t_build(tcfg).forward(params, {"tokens": torch.from_numpy(
            toks)})
    assert got.shape == (B, S, tcfg.padded_vocab)
    assert share(got, want) <= LOGIT_TOL


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
@pytest.mark.parametrize("layers", LAYERS)
def test_prefill_decode_and_greedy_match_jax(jx, trees, served, layers,
                                             impl):
    from repro_torch.launch.serve import generate
    _, tcfg = cfgs(jx, layers, attention_impl=impl)
    toks, want, greedy, _ = served(layers)
    m = t_build(tcfg)
    params = convert.model_params_from_numpy(tcfg, trees[layers],
                                             device="cpu")
    t = torch.from_numpy(toks)
    cache = m.init_cache(B, S + STEPS + 4, device="cpu")
    with torch.no_grad():
        logits, cache = m.prefill(params, {"tokens": t[:, :S]}, cache)
        got = [logits[:, 0]]
        for i in range(STEPS):
            logits, cache = m.decode_step(params, t[:, S + i:S + i + 1],
                                          cache)
            got.append(logits[:, 0])
    assert cache.length == S + STEPS
    assert share(torch.stack(got), want) <= LOGIT_TOL
    out = generate(m, params, {"tokens": t[:, :S]},
                   m.init_cache(B, S + STEPS + 4, device="cpu"), gen=STEPS)
    np.testing.assert_array_equal(out["tokens"], greedy)


@pytest.mark.parametrize("layers", LAYERS)
def test_decode_from_a_carried_jax_cache(jx, trees, served, layers):
    """The JAX cache after the prefill, carried across by
    ``zamba_cache_from_numpy``: the port's decode steps from it give the
    JAX decode logits."""
    _, tcfg = cfgs(jx, layers)
    toks, want, _, jcache = served(layers)
    cache = convert.zamba_cache_from_numpy(
        ssm=jcache.ssm.ssm, conv=jcache.ssm.conv, attn_k=jcache.attn_k,
        attn_v=jcache.attn_v, length=jcache.length, device="cpu")
    assert cache.length == S and cache.ssm.ssm.dtype == torch.float32
    assert cache.attn_k.shape == (layers // 6, B, S + STEPS + 4, 2, 16)
    params = convert.model_params_from_numpy(tcfg, trees[layers],
                                             device="cpu")
    t = torch.from_numpy(toks)
    got = []
    with torch.no_grad():
        for i in range(STEPS):
            logits, cache = TZ.decode_step(params, t[:, S + i:S + i + 1],
                                           tcfg, cache)
            got.append(logits[:, 0])
    assert share(torch.stack(got), want[1:]) <= LOGIT_TOL
    with pytest.raises(ValueError, match="ZambaCache"):
        convert.zamba_cache_from_numpy(
            ssm=jcache.ssm.ssm[0], conv=jcache.ssm.conv, attn_k=jcache.attn_k,
            attn_v=jcache.attn_v, length=S, device="cpu")


@pytest.mark.parametrize("layers,remat", [(n, "full") for n in LAYERS]
                         + [(LAYERS[0], "dots")],
                         ids=[str(n) for n in LAYERS] + [f"{LAYERS[0]}-dots"])
def test_loss_and_grads_match_jax(jx, trees, layers, remat):
    """``loss_fn`` and its gradients against ``jax.value_and_grad`` under
    the config's full remat (every Mamba2 layer, shared-block invocation
    and SSD chunk recomputed in the backward pass), with a masked label;
    and under ``"dots"``, which both packages run as ``"full"`` here."""
    jax, jnp = jx["jax"], jx["jnp"]
    jcfg, tcfg = cfgs(jx, layers, remat=remat)
    assert tcfg.remat == remat
    rng = np.random.default_rng(layers + 4)
    batch = {k: rng.integers(0, tcfg.vocab_size, (B, S), dtype=np.int32)
             for k in ("tokens", "labels")}
    batch["labels"][0, 3] = -1
    jloss, jgrads = jax.value_and_grad(jx["build_model"](jcfg).loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, trees[layers]),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.model_params_from_numpy(tcfg, trees[layers],
                                             device="cpu")
    for _, v in tree_items(params):
        v.requires_grad_(True)
    loss = t_build(tcfg).loss_fn(params, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, jgrads)))
    got = {k: v.grad.numpy() for k, v in tree_items(params)}
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.isfinite(got[k]).all(), k
        assert share(got[k], want[k]) <= GRAD_TOL, k


def test_multi_token_prompt_on_a_filled_cache_is_refused():
    """A prompt of S > 1 tokens on a non-empty cache raises before any
    state is written; one token a step is served."""
    cfg = t_get_config("zamba2-7b").reduced()
    m = t_build(cfg)
    params = m.init_params(torch.Generator().manual_seed(0), device="cpu")
    t = torch.from_numpy(tokens(0, cfg.vocab_size))
    with torch.no_grad():
        _, cache = m.prefill(params, {"tokens": t[:, :S]},
                             m.init_cache(B, S + STEPS + 4, device="cpu"))
        before = cache.ssm.ssm.clone(), cache.attn_k.clone()
        with pytest.raises(NotImplementedError, match="non-empty|rows"):
            m.prefill(params, {"tokens": t[:, S:S + 2]}, cache)
        assert torch.equal(cache.ssm.ssm, before[0])
        assert torch.equal(cache.attn_k, before[1])
        _, cache = m.decode_step(params, t[:, S:S + 1], cache)
    assert cache.length == S + 1
