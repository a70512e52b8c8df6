"""The port's dense transformer against the JAX package: each ``layers``
function against its JAX namesake, and the serving slice as a whole on
``qwen3-1.7b`` reduced (2 layers, d_model 64, float32) with the JAX
model's own parameters carried over by ``convert.model_params_from_numpy``;
the other dense configs (``llama3-8b``, ``internlm2-1.8b``,
``phi3-medium-14b``) the same way, and every config's published and reduced
fields against ``repro.configs`` (the MoE family's own tests are
``test_torch_moe.py``).

Tolerances: layers within 1e-6 absolute (float32, unit-scale inputs); the
model's logits within 1e-4 absolute (two layers of float32 products summed
in another order than XLA's), greedy tokens identical.  Port-internal
consistency (prefill against forward's tail, decode against forward) as
``tests/test_models.py::TestConsistency`` holds the JAX model: 2e-4 / 3e-4.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402

B, S, STEPS = 2, 12, 8
IMPLS = ["naive", "chunked", "kernel"]


@pytest.fixture
def jx():
    """The JAX package, with any mesh a test before left active switched
    off: ``launch/steps.py`` activates one and nothing deactivates it, and
    the model's ``shard`` calls then fail."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    return jax, jnp, JL


@pytest.fixture(scope="module")
def jax_model():
    """The reduced qwen3 of the JAX package: config, model, parameters (as
    NumPy), and its prefill/decode logits on one fixed token sequence."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_config
    from repro.models.registry import build_model
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    cfg = get_config("qwen3-1.7b").reduced()
    m = build_model(cfg)
    params = m.init_params(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + STEPS), dtype=np.int32)
    cache = m.init_cache(B, S + STEPS + 4)
    logits, cache = jax.jit(m.prefill)(params, {"tokens": toks[:, :S]}, cache)
    steps = [np.asarray(logits[:, 0])]
    decode = jax.jit(m.decode_step)
    for t in range(STEPS):
        logits, cache = decode(params, toks[:, S + t:S + t + 1], cache)
        steps.append(np.asarray(logits[:, 0]))
    # greedy generation from the prompt
    cache = m.init_cache(B, S + STEPS + 4)
    logits, cache = jax.jit(m.prefill)(params, {"tokens": toks[:, :S]}, cache)
    tok = np.asarray(logits[:, -1]).argmax(-1)[:, None].astype(np.int32)
    greedy = [tok]
    for _ in range(STEPS):
        logits, cache = decode(params, tok, cache)
        tok = np.asarray(logits[:, -1]).argmax(-1)[:, None].astype(np.int32)
        greedy.append(tok)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return cfg, tree, toks, np.stack(steps), np.concatenate(greedy, 1)


def port_cfg(impl):
    return dataclasses.replace(t_get_config("qwen3-1.7b").reduced(),
                               attention_impl=impl)


# -- layers --------------------------------------------------------------------


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def close(got, want, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def test_rms_norm(jx):
    _, jnp, JL = jx
    x, s = rand(3, 5, 64), rand(64, seed=1)
    close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
          JL.rms_norm(jnp.asarray(x), jnp.asarray(s)))


def test_layer_norm(jx):
    _, jnp, JL = jx
    x, s, b = rand(3, 5, 64), rand(64, seed=1), rand(64, seed=2)
    close(TL.layer_norm(*(torch.from_numpy(a) for a in (x, s, b))),
          JL.layer_norm(*(jnp.asarray(a) for a in (x, s, b))))


@pytest.mark.parametrize("with_bias", [False, True])
def test_init_norm(jx, with_bias):
    _, _, JL = jx
    got, want = TL.init_norm(8, with_bias=with_bias), JL.init_norm(
        8, with_bias=with_bias)
    assert sorted(got) == sorted(want)
    for k in got:
        close(got[k], want[k], atol=0)


def test_init_linear_scale():
    g = torch.Generator().manual_seed(0)
    w = TL.init_linear(g, 256, 512, dtype=torch.bfloat16)
    assert w.shape == (256, 512) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) - 256 ** -0.5) < 2e-3
    w2 = TL.init_linear(g, 64, 8, scale=0.02, lead=(3,))
    assert w2.shape == (3, 64, 8)
    assert abs(float(w2.std()) - 0.02) < 2e-3


@pytest.mark.parametrize("lead,block", [((), 1 << 24), ((3,), 1 << 24),
                                        ((3,), 100), ((2, 3), 1000)])
def test_init_linear_draws_in_blocks(monkeypatch, lead, block):
    """The result is allocated in its dtype and drawn a block of rows at a
    time: shapes, dtypes and scale hold at any block size, every slice of
    ``lead`` is drawn apart, and the float32 temporaries never exceed one
    block (``torch.randn`` is called with at most ``block`` elements, and
    at most one ``[d_in, d_out]`` slice)."""
    sizes = []
    randn = torch.randn

    def counting(shape, **kw):
        sizes.append(int(np.prod(shape)))
        return randn(shape, **kw)

    monkeypatch.setattr(TL, "DRAW_BLOCK", block)
    monkeypatch.setattr(torch, "randn", counting)
    g = torch.Generator().manual_seed(0)
    w = TL.init_linear(g, 64, 32, dtype=torch.bfloat16, lead=lead)
    assert w.shape == (*lead, 64, 32) and w.dtype == torch.bfloat16
    assert max(sizes) <= max(32, min(block, 64 * 32))
    assert sum(sizes) == w.numel()
    assert abs(float(w.float().std()) - 64 ** -0.5) < 1e-2
    flat = w.reshape(-1, 64, 32)
    assert all(not torch.equal(flat[0], m) for m in flat[1:])


def test_unbind_layers_nested_dicts_carry_gradients():
    """Nested dicts of any depth unbind into per-layer views, and the
    gradients reach each stacked ``[L, ...]`` leaf."""
    g = torch.Generator().manual_seed(0)
    params = {"layers": {
        "w": torch.randn((3, 4, 4), generator=g),
        "norm": {"scale": torch.randn((3, 4), generator=g)},
        "moe": {"router": torch.randn((3, 4, 2), generator=g),
                "shared": {"w_up": torch.randn((3, 4, 4), generator=g)}}}}
    leaves = [params["layers"]["w"], params["layers"]["norm"]["scale"],
              params["layers"]["moe"]["router"],
              params["layers"]["moe"]["shared"]["w_up"]]
    for t in leaves:
        t.requires_grad_(True)
    layers = TL.unbind_layers(params)
    assert len(layers) == 3
    x = torch.ones(4)
    loss = 0
    for i, p in enumerate(layers):
        assert p["moe"]["shared"]["w_up"].shape == (4, 4)
        y = (x * p["norm"]["scale"]) @ p["w"] @ p["moe"]["shared"]["w_up"]
        loss = loss + (i + 1) * ((y @ p["moe"]["router"]).sum())
    loss.backward()
    for t in leaves:
        assert t.grad is not None and t.grad.shape == t.shape
        for i in range(3):
            assert t.grad[i].abs().sum() > 0


def test_swiglu(jx):
    _, jnp, JL = jx
    xs = [rand(4, 32), rand(32, 48, seed=1) * 0.2, rand(32, 48, seed=2) * 0.2,
          rand(48, 32, seed=3) * 0.2]
    close(TL.swiglu(*(torch.from_numpy(a) for a in xs)),
          JL.swiglu(*(jnp.asarray(a) for a in xs)))


def test_gelu_mlp(jx):
    _, jnp, JL = jx
    xs = [rand(4, 32), rand(32, 48, seed=1) * 0.2, rand(48, 32, seed=3) * 0.2,
          rand(48, seed=4), rand(32, seed=5)]
    close(TL.gelu_mlp(*(torch.from_numpy(a) for a in xs)),
          JL.gelu_mlp(*(jnp.asarray(a) for a in xs)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_and_apply_rope(jx, theta):
    _, jnp, JL = jx
    pos = np.arange(24, dtype=np.int32).reshape(2, 12)
    tc, ts = TL.rope(torch.from_numpy(pos), 16, theta=theta)
    jc, js = JL.rope(jnp.asarray(pos), 16, theta=theta)
    close(tc, jc)
    close(ts, js)
    x = rand(2, 12, 4, 16)
    close(TL.apply_rope(torch.from_numpy(x), tc, ts),
          JL.apply_rope(jnp.asarray(x), jc, js))


def test_mask_padded_vocab(jx):
    _, jnp, JL = jx
    x = rand(2, 3, 512)
    close(TL.mask_padded_vocab(torch.from_numpy(x), 500),
          JL.mask_padded_vocab(jnp.asarray(x), 500), atol=0)
    close(TL.mask_padded_vocab(torch.from_numpy(x), 512), x, atol=0)


# -- the slice: prefill + decode against the JAX model -------------------------


def test_params_convert_exactly(jax_model):
    cfg, tree, *_ = jax_model
    params = convert.model_params_from_numpy(port_cfg("naive"), tree,
                                             device="cpu")
    close(params["embed"], tree["embed"], atol=0)
    close(params["layers"]["wq"], tree["layers"]["wq"], atol=0)
    close(params["layers"]["attn_norm"]["scale"],
          tree["layers"]["attn_norm"]["scale"], atol=0)
    assert "lm_head" not in params           # tied
    bad = dict(tree, layers=dict(tree["layers"]))
    bad["layers"]["wk"] = np.swapaxes(bad["layers"]["wk"], 1, 2)
    with pytest.raises(ValueError, match="wk"):
        convert.model_params_from_numpy(port_cfg("naive"), bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.model_params_from_numpy(
            port_cfg("naive"), {k: v for k, v in tree.items()
                                if k != "final_norm"}, device="cpu")


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_jax(jax_model, impl):
    _, tree, toks, want, _ = jax_model
    cfg = port_cfg(impl)
    m = t_build(cfg)
    params = convert.model_params_from_numpy(cfg, tree, device="cpu")
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
    close(torch.stack(got), want, atol=1e-4)


@pytest.mark.parametrize("impl", IMPLS)
def test_greedy_tokens_match_jax(jax_model, impl):
    from repro_torch.launch.serve import generate
    _, tree, toks, _, greedy = jax_model
    cfg = port_cfg(impl)
    m = t_build(cfg)
    params = convert.model_params_from_numpy(cfg, tree, device="cpu")
    out = generate(m, params, {"tokens": torch.from_numpy(toks[:, :S])},
                   m.init_cache(B, S + STEPS + 4, device="cpu"), gen=STEPS)
    np.testing.assert_array_equal(out["tokens"], greedy)
    assert out["cache_len"] == S + STEPS


# -- port-internal consistency -------------------------------------------------


@pytest.fixture(scope="module")
def port_model():
    cfg = port_cfg("chunked")
    m = t_build(cfg)
    params = m.init_params(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32))
    return cfg, m, params, toks


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_matches_forward_tail(port_model, impl):
    _, _, params, toks = port_model
    m = t_build(port_cfg(impl))
    with torch.no_grad():
        full = m.forward(params, {"tokens": toks})
        pre, cache = m.prefill(params, {"tokens": toks},
                               m.init_cache(B, S, device="cpu"))
    assert cache.length == S
    np.testing.assert_allclose(pre[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_matches_forward(port_model, impl):
    _, _, params, toks = port_model
    m = t_build(port_cfg(impl))
    with torch.no_grad():
        full = m.forward(params, {"tokens": toks})
        logits, cache = m.prefill(params, {"tokens": toks[:, :4]},
                                  m.init_cache(B, S + 8, device="cpu"))
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, 3].numpy(),
                                   rtol=2e-4, atol=2e-4)
        for t in range(4, S):
            logits, cache = m.decode_step(params, toks[:, t:t + 1], cache)
            np.testing.assert_allclose(logits[:, 0].numpy(),
                                       full[:, t].numpy(), rtol=3e-4,
                                       atol=3e-4)


def test_padded_vocab_never_wins(port_model):
    cfg, m, params, toks = port_model
    assert cfg.padded_vocab == cfg.vocab_size    # reduced: 512, no padding
    big = dataclasses.replace(cfg, vocab_size=500)
    params = TT.init_params(torch.Generator().manual_seed(0), big,
                            device="cpu")
    with torch.no_grad():
        logits = TT.forward(params, {"tokens": toks % 500}, big)
    assert logits.shape[-1] == 512
    assert (logits[..., 500:] == TL.NEG_INF).all()


@pytest.mark.parametrize("family,item", [
    ("audio", "the audio enc-dec family"), ("vlm", "transformer"),
    ("hybrid", "zamba2")])
def test_other_families_raise(family, item):
    """The audio family still raises, naming its ROADMAP item; the VLM and
    hybrid families build (``transformer`` and ``zamba2``)."""
    if family == "audio":
        cfg = dataclasses.replace(port_cfg("naive"), family=family)
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP Queue 1, {item}"):
            t_build(cfg)
        return
    arch = {"vlm": "qwen2-vl-72b", "hybrid": "zamba2-7b"}[family]
    m = t_build(t_get_config(arch).reduced())
    assert m.cfg.family == family
    assert m.module.__name__ == f"repro_torch.models.{item}"


def test_mrope_raises(jx):
    """``mrope_frequencies`` against JAX's with three distinct position
    streams (the reduced split (2, 3, 3) and qwen2-vl's (16, 24, 24), float32
    angles), within 1e-6; a split that does not sum to ``head_dim / 2``
    raises, as JAX asserts."""
    _, jnp, JL = jx
    rng = np.random.default_rng(7)
    pos = rng.integers(0, 64, (3, B, S)).astype(np.int32)
    for sections in ((2, 3, 3), (16, 24, 24)):
        hd = 2 * sum(sections)
        got = TL.mrope_frequencies(torch.from_numpy(pos), hd, sections,
                                   theta=1e6)
        want = JL.mrope_frequencies(jnp.asarray(pos), hd, sections,
                                    theta=1e6)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == (B, S, hd // 2)
            close(g, w, atol=1e-6)
        # the streams differ, so no single stream's RoPE gives the tables
        for i in range(3):
            assert not torch.allclose(got[0], TL.rope(
                torch.from_numpy(pos[i]), hd, theta=1e6)[0])
        with pytest.raises(AssertionError):
            TL.mrope_frequencies(torch.from_numpy(pos), hd + 2, sections)


def test_config_matches_jax_published_widths():
    pytest.importorskip("jax")
    from repro.configs import get_config
    j, t = get_config("qwen3-1.7b"), t_get_config("qwen3-1.7b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "qk_norm", "rope_theta",
              "act", "tie_embeddings", "param_dtype", "compute_dtype",
              "padded_vocab"):
        assert getattr(t, f) == getattr(j, f), f
    jr, tr = j.reduced(), t.reduced()
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "attention_chunk"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert dataclasses.replace(t, attention_impl="pallas").attention_impl \
        == "kernel"


ZOO = ["llama3-8b", "internlm2-1.8b", "phi3-medium-14b",
       "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]
DENSE_ZOO = ZOO[:3]
ZOO_FIELDS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "qk_norm", "rope_theta",
              "act", "tie_embeddings", "param_dtype", "compute_dtype",
              "remat", "train_microbatches", "norm_type", "num_experts",
              "num_experts_per_token", "num_shared_experts",
              "capacity_factor", "router_aux_coef", "attention_chunk",
              "padded_vocab")


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_config_matches_jax(arch):
    """Every field the port keeps, published and reduced, equals the JAX
    package's."""
    pytest.importorskip("jax")
    from repro.configs import get_config
    j, t = get_config(arch), t_get_config(arch)
    for f in ZOO_FIELDS:
        assert getattr(t, f) == getattr(j, f), f
        assert getattr(t.reduced(), f) == getattr(j.reduced(), f), f


@pytest.fixture(scope="module")
def dense_zoo_runs():
    """arch -> the reduced JAX model's tree (NumPy), tokens, prefill and
    decode logits and greedy tokens, as ``jax_model`` for qwen3; computed
    on first use."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_config
    from repro.models.registry import build_model
    from repro.sharding import api as shard_api
    runs = {}

    def run(arch):
        if arch in runs:
            return runs[arch]
        shard_api.deactivate()
        cfg = get_config(arch).reduced()
        m = build_model(cfg)
        params = m.init_params(jax.random.PRNGKey(2))
        toks = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (B, S + STEPS), dtype=np.int32)
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
            tok = np.asarray(logits[:, -1]).argmax(-1)[:, None].astype(
                np.int32)
            greedy.append(tok)
        runs[arch] = (jax.tree_util.tree_map(np.asarray, params), toks,
                      np.stack(steps), np.concatenate(greedy, 1))
        return runs[arch]

    return run


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", DENSE_ZOO)
def test_dense_zoo_prefill_decode_and_greedy_match_jax(dense_zoo_runs, arch,
                                                       impl):
    """Prefill, 8 teacher-forced decode steps and greedy tokens of each
    other dense config, reduced, against the JAX model (the qwen3
    tolerance: 1e-4 absolute on the logits)."""
    from repro_torch.launch.serve import generate
    tree, toks, want, greedy = dense_zoo_runs(arch)
    cfg = dataclasses.replace(t_get_config(arch).reduced(),
                              attention_impl=impl)
    m = t_build(cfg)
    params = convert.model_params_from_numpy(cfg, tree, device="cpu")
    t = torch.from_numpy(toks)
    cache = m.init_cache(B, S + STEPS + 4, device="cpu")
    with torch.no_grad():
        logits, cache = m.prefill(params, {"tokens": t[:, :S]}, cache)
        got = [logits[:, 0]]
        for i in range(STEPS):
            logits, cache = m.decode_step(params, t[:, S + i:S + i + 1],
                                          cache)
            got.append(logits[:, 0])
    close(torch.stack(got), want, atol=1e-4)
    out = generate(m, params, {"tokens": t[:, :S]},
                   m.init_cache(B, S + STEPS + 4, device="cpu"), gen=STEPS)
    np.testing.assert_array_equal(out["tokens"], greedy)


FAMILY_FIELDS = ZOO_FIELDS + ("mrope_sections", "frontend_tokens",
                              "ssm_state", "ssm_expand", "ssm_headdim",
                              "ssm_conv", "shared_attn_period", "lora_rank")


@pytest.mark.parametrize("arch,item", [
    ("qwen2-vl-72b", "the VLM family"), ("zamba2-7b", "the hybrid family"),
    ("seamless-m4t-large-v2", "the audio enc-dec family")])
def test_unported_archs_raise(arch, item):
    """``seamless-m4t-large-v2`` still raises, naming its ROADMAP item; the
    VLM and hybrid configs now carry the JAX package's published and
    reduced field values."""
    with pytest.raises(KeyError):
        t_get_config("no-such-arch")
    if arch == "seamless-m4t-large-v2":
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP Queue 1, {item}"):
            t_get_config(arch)
        return
    pytest.importorskip("jax")
    from repro.configs import get_config
    j, t = get_config(arch), t_get_config(arch)
    for f in FAMILY_FIELDS:
        assert getattr(t, f) == getattr(j, f), f
        assert getattr(t.reduced(), f) == getattr(j.reduced(), f), f
