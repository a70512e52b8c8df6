"""The port's RWKV-6 model (the SSM family) against the JAX package, on
``rwkv6-1.6b`` reduced (2 layers, d_model 64, 4 wkv heads of 16, float32)
with the JAX model's own parameters carried over by
``convert.model_params_from_numpy``.

The JAX init leaves two terms of the recurrence idle -- the bonus ``u``
starts at zero and ``w0`` at a constant -6 -- so the tests overwrite both
in the JAX NumPy tree with seeded values (u unit normal times 0.5, w0
uniform in [-4, 0]: decays from ~0.98 to ~0.37) before either package
runs it.

Tolerances: logits within 1e-4 absolute (two layers of float32 products
summed in another order than XLA's; |logit| ~ 1), greedy tokens identical;
the final ``wkv`` state within 1e-4 of its max |.| and the token-shift
states within 1e-5 absolute (layer-norm outputs, |x| ~ 1).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels import linear_scan as LS  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import rwkv6 as TR  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402

ARCH = "rwkv6-1.6b"
B, S, STEPS = 2, 64, 8       # S: two of the reduced config's 32-token chunks
IMPLS = ["chunked", "kernel"]


def _deactivate_mesh():
    """``launch/steps.py`` activates a sharding mesh and nothing
    deactivates it; the JAX model's ``shard`` calls then fail."""
    from repro.sharding import api as shard_api
    shard_api.deactivate()


def _state_np(state):
    return dict(wkv=np.asarray(state.wkv),
                shift_tm=np.asarray(state.shift_tm),
                shift_cm=np.asarray(state.shift_cm),
                length=int(state.length))


@pytest.fixture(scope="module")
def jax_run():
    """The reduced rwkv6 of the JAX package with ``u`` and ``w0``
    perturbed: its parameters (NumPy), one token sequence, the prefill +
    teacher-forced decode logits, the state after the prefill and at the
    end, the forward logits over the prompt and the greedy tokens from
    it."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_config
    from repro.models.registry import build_model
    _deactivate_mesh()
    cfg = get_config(ARCH).reduced()
    m = build_model(cfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  m.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    lay = tree["layers"]
    lay["u"] = (0.5 * rng.standard_normal(lay["u"].shape)).astype(np.float32)
    lay["w0"] = rng.uniform(-4.0, 0.0, lay["w0"].shape).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S + STEPS), dtype=np.int32)
    prefill, decode = jax.jit(m.prefill), jax.jit(m.decode_step)

    logits, cache = prefill(tree, {"tokens": toks[:, :S]},
                            m.init_cache(B, S + STEPS))
    after_prefill = _state_np(cache)
    steps = [np.asarray(logits[:, 0])]
    for t in range(STEPS):
        logits, cache = decode(tree, toks[:, S + t:S + t + 1], cache)
        steps.append(np.asarray(logits[:, 0]))
    final = _state_np(cache)
    full = np.asarray(jax.jit(m.forward)(tree, {"tokens": toks[:, :S]})[0])

    logits, cache = prefill(tree, {"tokens": toks[:, :S]},
                            m.init_cache(B, S + STEPS))
    tok = np.asarray(logits[:, -1]).argmax(-1)[:, None].astype(np.int32)
    greedy = [tok]
    for _ in range(STEPS):
        logits, cache = decode(tree, tok, cache)
        tok = np.asarray(logits[:, -1]).argmax(-1)[:, None].astype(np.int32)
        greedy.append(tok)
    return dict(tree=tree, toks=toks, steps=np.stack(steps, 1),
                after_prefill=after_prefill, final=final, full=full,
                greedy=np.concatenate(greedy, 1))


def port_model(impl):
    cfg = dataclasses.replace(t_get_config(ARCH).reduced(),
                              attention_impl=impl)
    return t_build(cfg)


def port_params(jr):
    return convert.model_params_from_numpy(port_model("chunked").cfg,
                                           jr["tree"], device="cpu")


def run_teacher_forced(m, params, toks, cache):
    with torch.no_grad():
        logits, cache = m.prefill(params, {"tokens": toks[:, :S]}, cache)
        steps = [logits[:, 0]]
        for t in range(STEPS):
            logits, cache = m.decode_step(params, toks[:, S + t:S + t + 1],
                                          cache)
            steps.append(logits[:, 0])
    return torch.stack(steps, 1).numpy(), cache


def assert_state_close(got, want):
    wkv = want["wkv"]
    assert got.length == want["length"]
    assert np.abs(got.wkv.numpy() - wkv).max() <= 1e-4 * np.abs(wkv).max()
    for name in ("shift_tm", "shift_cm"):
        t = getattr(got, name)
        assert str(t.dtype).removeprefix("torch.") == want[name].dtype.name
        np.testing.assert_allclose(t.numpy(), want[name], rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_jax(jax_run, impl):
    m = port_model(impl)
    toks = torch.from_numpy(jax_run["toks"])
    got, cache = run_teacher_forced(m, port_params(jax_run), toks,
                                    m.init_cache(B, S + STEPS, device="cpu"))
    np.testing.assert_allclose(got, jax_run["steps"], rtol=0, atol=1e-4)
    assert_state_close(cache, jax_run["final"])


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(jax_run, impl):
    m = port_model(impl)
    with torch.no_grad():
        got = m.forward(port_params(jax_run),
                        {"tokens": torch.from_numpy(jax_run["toks"][:, :S])})
    np.testing.assert_allclose(got.numpy(), jax_run["full"], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("impl", IMPLS)
def test_greedy_tokens_match_jax(jax_run, impl):
    m = port_model(impl)
    params = port_params(jax_run)
    toks = torch.from_numpy(jax_run["toks"][:, :S])
    with torch.no_grad():
        logits, cache = m.prefill(params, {"tokens": toks},
                                  m.init_cache(B, S + STEPS, device="cpu"))
        tok = logits[:, -1].argmax(-1, keepdim=True).int()
        greedy = [tok]
        for _ in range(STEPS):
            logits, cache = m.decode_step(params, tok, cache)
            tok = logits[:, -1].argmax(-1, keepdim=True).int()
            greedy.append(tok)
    np.testing.assert_array_equal(torch.cat(greedy, 1).numpy(),
                                  jax_run["greedy"])


def test_decode_from_a_jax_state(jax_run):
    """Decode steps from the JAX state after the prefill, carried across by
    ``rwkv_state_from_numpy``, give the JAX decode logits and end state."""
    m = port_model("kernel")
    params = port_params(jax_run)
    cache = convert.rwkv_state_from_numpy(**jax_run["after_prefill"],
                                          device="cpu")
    assert cache.length == S and cache.shift_tm.dtype == torch.float32
    toks = torch.from_numpy(jax_run["toks"])
    steps = []
    with torch.no_grad():
        for t in range(STEPS):
            logits, cache = m.decode_step(params, toks[:, S + t:S + t + 1],
                                          cache)
            steps.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               jax_run["steps"][:, 1:], rtol=0, atol=1e-4)
    assert_state_close(cache, jax_run["final"])


def test_prefill_then_decode_matches_forward():
    """Port-internal consistency, as ``tests/test_models.py`` holds the
    JAX model: prefill's last logits and each decode step against
    ``forward`` over the whole sequence."""
    m = port_model("chunked")
    params = m.init_params(torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, m.cfg.vocab_size, (B, 64), dtype=np.int32))
    with torch.no_grad():
        full = m.forward(params, {"tokens": toks})
        logits, cache = m.prefill(params, {"tokens": toks[:, :32]},
                                  m.init_cache(B, 0, device="cpu"))
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, 31].numpy(),
                                   rtol=2e-4, atol=2e-4)
        for t in range(32, 64):
            logits, cache = m.decode_step(params, toks[:, t:t + 1], cache)
            np.testing.assert_allclose(logits[:, 0].numpy(),
                                       full[:, t].numpy(), rtol=3e-4,
                                       atol=3e-4)


def test_state_is_updated_in_place_and_shift_dtype_follows_jax():
    """The ``wkv`` tensor is written in place; the shifts start float32
    and come back in the compute dtype, as in the JAX package."""
    cfg = dataclasses.replace(t_get_config(ARCH).reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    m = t_build(cfg)
    params = m.init_params(torch.Generator().manual_seed(2), device="cpu")
    cache = m.init_cache(1, 0, device="cpu")
    wkv = cache.wkv
    assert cache.shift_tm.dtype == cache.shift_cm.dtype == torch.float32
    with torch.no_grad():
        logits, cache = m.prefill(
            params, {"tokens": torch.zeros((1, 8), dtype=torch.int32)},
            cache)
    assert cache.wkv is wkv and wkv.abs().max() > 0
    assert cache.wkv.dtype == torch.float32
    assert cache.shift_tm.dtype == cache.shift_cm.dtype == torch.bfloat16
    assert logits.shape == (1, 1, cfg.padded_vocab) and cache.length == 8


def test_prompt_must_fill_whole_chunks():
    """As ``wkv_chunked`` asserts: a prompt longer than the chunk must be a
    multiple of it, whatever the impl."""
    for impl in IMPLS:
        m = port_model(impl)
        params = m.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
        with pytest.raises(ValueError, match="multiple of the chunk"):
            m.prefill(params, {"tokens": torch.zeros((1, 40),
                                                     dtype=torch.int32)},
                      m.init_cache(1, 0, device="cpu"))


def test_config_matches_jax_published_widths():
    pytest.importorskip("jax")
    from repro.configs import get_config
    j, t = get_config(ARCH), t_get_config(ARCH)
    fields = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "rwkv_decay_lora",
              "rwkv_mix_lora", "act", "norm_type", "param_dtype",
              "compute_dtype", "attention_impl", "attention_chunk",
              "padded_vocab")
    for f in fields:
        assert getattr(t, f) == getattr(j, f), f
    jr, tr = j.reduced(), t.reduced()
    for f in fields:
        assert getattr(tr, f) == getattr(jr, f), f
    assert (t.num_layers, t.d_model, t.num_heads, t.head_dim, t.d_ff,
            t.vocab_size, t.rwkv_decay_lora, t.rwkv_mix_lora) \
        == (24, 2048, 32, 64, 7168, 65536, 64, 32)
    assert (tr.num_layers, tr.d_model, tr.num_heads, tr.head_dim,
            tr.rwkv_decay_lora, tr.rwkv_mix_lora) == (2, 64, 4, 16, 8, 4)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_full_width_shapes_match_jax_and_count_1_6b():
    """The published widths' parameter tree, shapes only (nothing
    allocated): every leaf's shape equal to the JAX tree's
    (``jax.eval_shape``), ~1.6 B parameters in all."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_config
    from repro.models import rwkv6 as JR
    want = jax.eval_shape(lambda k: JR.init_params(k, get_config(ARCH)),
                          jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in _leaves(want)}
    got = dict(_leaves(TR.param_shapes(t_get_config(ARCH))))
    assert got == want
    n = sum(int(np.prod(s)) for s in got.values())
    assert 1.5e9 < n < 1.7e9, n


def test_init_params_follows_the_jax_init():
    cfg = t_get_config(ARCH).reduced()
    p = TR.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    lay = p["layers"]
    assert torch.equal(lay["u"], torch.zeros_like(lay["u"]))
    assert torch.equal(lay["w0"], torch.full_like(lay["w0"], -6.0))
    assert torch.equal(lay["mix_base"], torch.full_like(lay["mix_base"], .5))
    assert lay["ln_x"]["scale"].shape == (2, 64)
    # mix_up is 0.02 * normal; projections normal / sqrt(d_in)
    assert 0.01 < float(lay["mix_up"].std()) < 0.03
    assert abs(float(lay["w_up"].std()) - 8 ** -0.5) < 0.05
    assert abs(float(p["embed"].std()) - 0.02) < 0.002


def test_convert_rejects_a_tree_of_the_wrong_family(jax_run):
    qwen = t_get_config("qwen3-1.7b").reduced()
    with pytest.raises(ValueError, match="keys"):
        convert.model_params_from_numpy(qwen, jax_run["tree"], device="cpu")


def test_rwkv_state_from_numpy_checks_shapes():
    with pytest.raises(ValueError, match="RWKVState"):
        convert.rwkv_state_from_numpy(
            wkv=np.zeros((2, 1, 4, 16, 16), np.float32),
            shift_tm=np.zeros((2, 1, 64), np.float32),
            shift_cm=np.zeros((2, 2, 64), np.float32), length=0,
            device="cpu")


@pytest.fixture
def jax_serve():
    pytest.importorskip("jax")
    from repro.launch.serve import serve
    _deactivate_mesh()
    return serve


def test_serve_dict_matches_jax(jax_serve):
    """Same keys, token shape, dtype and cache length as the JAX
    ``serve`` on the reduced rwkv6."""
    kw = dict(batch=2, prompt_len=8, gen=3)
    want = jax_serve(ARCH, **kw)
    got = TS.serve(ARCH, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    assert got["tokens"].shape == want["tokens"].shape == (2, 4)
    assert got["cache_len"] == want["cache_len"] == 11
    assert got["tokens"].dtype == np.int32


def test_cpu_serve_launches_no_kernel():
    before = LS.wkv_linear_scan.launches
    model, params, batch, cache, _ = TS.prepare(
        ARCH, batch=1, prompt_len=4, gen=2, attention_impl="kernel",
        device="cpu")
    assert isinstance(cache, TR.RWKVState)
    out = TS.generate(model, params, batch, cache, gen=2)
    assert out["tokens"].shape == (1, 3) and out["cache_len"] == 6
    assert LS.wkv_linear_scan.launches == before


@pytest.mark.cuda
def test_cuda_serve_goes_through_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    LS.wkv_linear_scan.launches = 0
    out = TS.serve(ARCH, batch=2, prompt_len=32, gen=5)
    assert out["tokens"].shape == (2, 6) and out["cache_len"] == 37
    # reduced config: 2 layers, one launch per layer per prefill and per
    # decode step
    assert LS.wkv_linear_scan.launches == 2 + 2 * 5
