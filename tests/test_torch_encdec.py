"""The port's enc-dec model (the audio family, ``models/encdec.py``) against
the JAX package, on the reduced ``seamless-m4t-large-v2`` (2 encoder + 2
decoder layers, d_model 64, 4 q / 2 kv heads of 16, d_ff 96, vocab 512,
float32), sharding off, with the JAX model's parameters carried over by
``convert.model_params_from_numpy``.

Held: the parameter tree's keys, shapes and dtypes; ``encode`` and
``forward`` at each attention impl (the encoder's full self-attention,
and cross-attention with ``Sq != Sk``, reach the flash wrapper under
``"kernel"``); ``loss_fn`` and its gradients against
``jax.value_and_grad`` under the config's full remat; a prefill plus 8
teacher-forced decode steps and the greedy tokens of ``generate``; 8
decode steps from a JAX cache carried by ``convert.encdec_cache_from_numpy``;
``make_batch``'s frame / token split against the JAX package's; and the
CPU ``serve`` loop.

Tolerances (``tests/test_torch_vlm.py``'s): logits within 1e-5 of their
max |logit| (float32 sums in another order than XLA's), greedy tokens
identical; the loss within 1e-5 relative, each gradient leaf within 1e-4 of
its max |g|.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402
from repro_torch.models.registry import make_batch as t_make_batch  # noqa
from repro_torch.tree import tree_items  # noqa: E402

ARCH = "seamless-m4t-large-v2"
B, S_ENC, S_DEC, STEPS = 2, 24, 10, 8
LOGIT_TOL, LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5, 1e-4
IMPLS = ["naive", "chunked", "kernel"]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces, with any mesh a test before left active
    switched off (``launch/steps.py`` activates one)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import encdec as JE
    from repro.models import registry as JR
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    return dict(jax=jax, jnp=jnp, cfg=get_config(ARCH).reduced(), JR=JR,
                JE=JE)


@pytest.fixture(scope="module")
def tree(jx):
    jax = jx["jax"]
    return jax.tree_util.tree_map(np.asarray, jx["JR"].build_model(
        jx["cfg"]).init_params(jax.random.PRNGKey(3)))


def port(impl="chunked"):
    return dataclasses.replace(t_get_config(ARCH).reduced(),
                               attention_impl=impl)


def inputs(seed, vocab, d=64):
    """frames ``[B, S_ENC, d]``, tokens ``[B, S_DEC + STEPS]`` and labels
    ``[B, S_DEC]`` (one masked), from one seeded generator."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S_ENC, d)).astype(np.float32)
    toks = rng.integers(0, vocab, (B, S_DEC + STEPS), dtype=np.int32)
    labels = rng.integers(0, vocab, (B, S_DEC), dtype=np.int32)
    labels[0, 3] = -1
    return frames, toks, labels


def share(got, want):
    """max |got - want| as a share of max |want|."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def both(jx, **arrays):
    jnp = jx["jnp"]
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in arrays.items()})


def test_param_tree_matches_jax(jx, tree):
    """The port's init gives the JAX tree's keys, shapes and dtypes, at the
    reduced widths and (by ``param_shapes``) at the published ones."""
    cfg = port()
    got = TE.init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in tree_items(tree)}
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tree_items(got)} == want
    jax = jx["jax"]
    from repro.configs import get_config
    full = jax.eval_shape(lambda: jx["JR"].build_model(
        get_config(ARCH)).init_params(jax.random.PRNGKey(0)))
    assert dict(tree_items(TE.param_shapes(t_get_config(ARCH)))) == {
        k: tuple(v.shape) for k, v in tree_items(full)}


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_and_forward_match_jax(jx, tree, impl):
    """``encode`` (full self-attention, RoPE over the frames) and
    ``forward`` (the decoder's causal and cross-attention); under
    ``"kernel"`` the flash wrapper takes every prefill attention, full
    ones included (3 per decoder layer pair: encoder, self, cross)."""
    jax, jnp = jx["jax"], jx["jnp"]
    cfg = port(impl)
    frames, toks, _ = inputs(1, cfg.vocab_size)
    jb, tb = both(jx, embeds=frames, tokens=toks[:, :S_DEC])
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    want_enc = jx["JE"].encode(jparams, jb["embeds"], jx["cfg"])
    want, _ = jx["JE"].forward(jparams, jb, jx["cfg"])
    params = convert.model_params_from_numpy(cfg, tree, device="cpu")
    calls = []
    real = FA.flash_attention_plain

    def spy(q, k, v, *, causal=True, scale=None):
        calls.append((q.shape[1], k.shape[1], causal))
        return real(q, k, v, causal=causal, scale=scale)

    FA.flash_attention_plain = spy
    try:
        with torch.no_grad():
            enc = TE.encode(params, tb["embeds"], cfg)
            got = TE.forward(params, tb, cfg)
    finally:
        FA.flash_attention_plain = real
    assert enc.shape == (B, S_ENC, cfg.d_model)
    assert got.shape == (B, S_DEC, cfg.padded_vocab)
    assert share(enc, want_enc) <= LOGIT_TOL
    assert share(got, want) <= LOGIT_TOL
    n_enc, n_dec = cfg.num_layers, cfg.num_decoder_layers
    if impl == "kernel":
        assert sorted(calls) == sorted(
            [(S_ENC, S_ENC, False)] * 2 * n_enc
            + [(S_DEC, S_DEC, True), (S_DEC, S_ENC, False)] * n_dec)
    else:
        assert calls == []


def loss_and_grads_against_jax(jx, tree, remat):
    """``loss_fn`` (one label masked) and its gradients against
    ``jax.value_and_grad``, both configs under ``remat``."""
    jax, jnp = jx["jax"], jx["jnp"]
    cfg = dataclasses.replace(port(), remat=remat)
    frames, toks, labels = inputs(2, cfg.vocab_size)
    jb, tb = both(jx, embeds=frames, tokens=toks[:, :S_DEC], labels=labels)
    jloss, jgrads = jax.value_and_grad(jx["JR"].build_model(
        dataclasses.replace(jx["cfg"], remat=remat)).loss_fn)(
            jax.tree_util.tree_map(jnp.asarray, tree), jb)
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


def test_loss_and_grads_match_jax(jx, tree):
    """Under the config's full remat."""
    assert port().remat == "full"
    loss_and_grads_against_jax(jx, tree, "full")


def test_loss_and_grads_match_jax_under_dots(jx, tree):
    """Under ``"dots"``, which both packages run as ``"full"`` in this
    family (JAX checks ``cfg.remat in ("full", "dots")``)."""
    loss_and_grads_against_jax(jx, tree, "dots")


def test_remat_changes_no_gradient(tree):
    """The blocks under ``torch.utils.checkpoint`` (``remat="full"``) give
    the gradients of the plain run."""
    frames, toks, labels = inputs(3, 512)
    batch = {"embeds": torch.from_numpy(frames),
             "tokens": torch.from_numpy(toks[:, :S_DEC]),
             "labels": torch.from_numpy(labels)}
    grads = []
    for remat in ("full", "none"):
        cfg = dataclasses.replace(port(), remat=remat)
        params = convert.model_params_from_numpy(cfg, tree, device="cpu")
        for _, v in tree_items(params):
            v.requires_grad_(True)
        TE.loss_fn(params, batch, cfg).backward()
        grads.append({k: v.grad for k, v in tree_items(params)})
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=0,
                                   atol=1e-6)


def jax_serve(jx, tree, frames, toks):
    """The JAX prefill + STEPS teacher-forced decode logits, the cache after
    the prefill (NumPy) and the greedy tokens from the prompt."""
    jax, jnp = jx["jax"], jx["jnp"]
    m = jx["JR"].build_model(jx["cfg"])
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    prefill, decode = jax.jit(m.prefill), jax.jit(m.decode_step)
    jb = {"embeds": jnp.asarray(frames), "tokens": jnp.asarray(
        toks[:, :S_DEC])}
    fresh = m.init_cache(B, S_DEC + STEPS + 4, enc_len=S_ENC)
    logits, cache = prefill(params, jb, fresh)
    after = {k: np.asarray(getattr(cache, k)) for k in (
        "enc_out", "self_k", "self_v", "cross_k", "cross_v", "length")}
    steps = [np.asarray(logits[:, 0])]
    for t in range(STEPS):
        logits, cache = decode(params, toks[:, S_DEC + t:S_DEC + t + 1],
                               cache)
        steps.append(np.asarray(logits[:, 0]))
    logits, cache = prefill(params, jb, m.init_cache(
        B, S_DEC + STEPS + 4, enc_len=S_ENC))
    tok = np.asarray(logits[:, -1]).argmax(-1)[:, None].astype(np.int32)
    greedy = [tok]
    for _ in range(STEPS):
        logits, cache = decode(params, tok, cache)
        tok = np.asarray(logits[:, -1]).argmax(-1)[:, None].astype(np.int32)
        greedy.append(tok)
    return np.stack(steps), after, np.concatenate(greedy, 1)


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_prefill_decode_and_greedy_match_jax(jx, tree, impl):
    """Prefill fills the cross cache (all ``S_ENC`` rows) and the first
    ``S_DEC`` decoder rows as JAX's does; 8 teacher-forced steps; greedy
    tokens of ``generate`` identical."""
    from repro_torch.launch.serve import generate
    cfg = port(impl)
    frames, toks, _ = inputs(4, cfg.vocab_size)
    want, after, greedy = jax_serve(jx, tree, frames, toks)
    m = t_build(cfg)
    params = convert.model_params_from_numpy(cfg, tree, device="cpu")
    t = torch.from_numpy(toks)
    tb = {"embeds": torch.from_numpy(frames), "tokens": t[:, :S_DEC]}
    cache = m.init_cache(B, S_DEC + STEPS + 4, enc_len=S_ENC, device="cpu")
    with torch.no_grad():
        logits, cache = m.prefill(params, tb, cache)
        assert cache.length == S_DEC == int(after["length"])
        for k in ("enc_out", "cross_k", "cross_v"):
            assert share(getattr(cache, k), after[k]) <= LOGIT_TOL, k
        for k in ("self_k", "self_v"):
            assert share(getattr(cache, k)[:, :, :S_DEC],
                         after[k][:, :, :S_DEC]) <= LOGIT_TOL, k
        got = [logits[:, 0]]
        for i in range(STEPS):
            logits, cache = m.decode_step(
                params, t[:, S_DEC + i:S_DEC + i + 1], cache)
            got.append(logits[:, 0])
    assert share(torch.stack(got), want) <= LOGIT_TOL
    out = generate(m, params, tb, m.init_cache(
        B, S_DEC + STEPS + 4, enc_len=S_ENC, device="cpu"), gen=STEPS)
    np.testing.assert_array_equal(out["tokens"], greedy)
    assert out["cache_len"] == S_DEC + STEPS


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_decode_from_a_jax_cache(jx, tree, impl):
    """8 decode steps from the JAX cache after its prefill, carried over by
    ``encdec_cache_from_numpy``, against JAX's own steps."""
    cfg = port(impl)
    frames, toks, _ = inputs(5, cfg.vocab_size)
    want, after, _ = jax_serve(jx, tree, frames, toks)
    cache = convert.encdec_cache_from_numpy(**after, device="cpu")
    assert cache.length == S_DEC and isinstance(cache.length, int)
    params = convert.model_params_from_numpy(cfg, tree, device="cpu")
    t = torch.from_numpy(toks)
    got = []
    with torch.no_grad():
        for i in range(STEPS):
            logits, cache = TE.decode_step(
                params, t[:, S_DEC + i:S_DEC + i + 1], cfg, cache)
            got.append(logits[:, 0])
    assert share(torch.stack(got), want[1:]) <= LOGIT_TOL
    with pytest.raises(ValueError, match="EncDecCache"):
        convert.encdec_cache_from_numpy(
            **dict(after, cross_k=after["cross_k"][:, :, 1:]), device="cpu")


def test_cache_checks():
    """A cache whose encoder rows are not the prompt's frame count, and a
    full decoder cache, raise."""
    cfg = port()
    params = TE.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    frames, toks, _ = inputs(6, cfg.vocab_size)
    tb = {"embeds": torch.from_numpy(frames),
          "tokens": torch.from_numpy(toks[:, :S_DEC])}
    with torch.no_grad(), pytest.raises(ValueError, match="enc_len"):
        TE.prefill(params, tb, cfg, TE.init_cache(
            cfg, B, S_DEC + 1, enc_len=S_ENC - 1, device="cpu"))
    with torch.no_grad():
        _, cache = TE.prefill(params, tb, cfg, TE.init_cache(
            cfg, B, S_DEC + 1, enc_len=S_ENC, device="cpu"))
        _, cache = TE.decode_step(params, tb["tokens"][:, :1], cfg, cache)
        with pytest.raises(RuntimeError, match="cache full"):
            TE.decode_step(params, tb["tokens"][:, :1], cfg, cache)


@pytest.mark.parametrize("s,train", [(40, True), (40, False), (7, False)])
def test_make_batch_splits_frames_and_tokens(jx, s, train):
    """``make_batch`` gives the JAX package's keys, shapes and dtypes: a
    training batch ``s // 2`` frames and ``s - s // 2`` tokens (and
    labels), a serving batch ``s`` frames and ``max(1, s // 8)`` tokens;
    frames are 0.02-scale normals in the compute dtype."""
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
    assert abs(float(got["embeds"].float().std()) - 0.02) < 4e-3


def test_serve_runs_on_the_cpu():
    """The port's ``serve`` for seamless on the CPU: ``prompt_len`` frames
    and ``prompt_len // 8`` decoder tokens, the JAX ``serve``'s dict, its
    cache length the decoder's tokens plus ``gen``, deterministic for a
    seed."""
    from repro_torch.launch.serve import serve
    kw = dict(batch=2, prompt_len=32, gen=5, device="cpu")
    out = serve(ARCH, **kw)
    assert out["tokens"].shape == (2, 6)
    assert out["cache_len"] == 32 // 8 + 5
    assert out["tokens"].max() < t_get_config(ARCH).reduced().vocab_size
    assert out["prefill_s"] > 0 and out["decode_p50_ms"] > 0
    np.testing.assert_array_equal(serve(ARCH, **kw)["tokens"], out["tokens"])
