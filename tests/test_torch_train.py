"""The port's training slice against the JAX package, on ``qwen3-1.7b``
reduced (2 layers, d_model 64, float32, full remat) with the JAX model's
own parameters carried over by ``convert.model_params_from_numpy``:
``loss_fn`` and its gradients, ``adamw_update`` from a carried-over
optimizer state (``convert.opt_state_from_numpy``), and one whole step at
microbatches 1 and 2 and at ``grad_bits`` 16 and 8 against the JAX step
composed from its pieces as ``launch/steps.py::train_step`` composes them
(``Model.loss_fn``, ``jax.value_and_grad``, the scan over microbatches,
``make_grad_compressor``'s hook, ``adamw_update``), with sharding off.  The
JAX ``train()`` itself cannot run on this JAX (its explicit-axes mesh makes
``sharding/api.py`` reject every sharding constraint), so the port's
``train`` is held to the behaviour ``tests/test_train_e2e.py::TestTraining``
asks of it, on the CPU.  Also: ``TokenStream`` against JAX's, the
Checkpointer as ``tests/test_runtime.py`` holds JAX's, AdamW's own
properties.

Tolerances (float32): the loss within 1e-5 relative and each gradient
leaf within 1e-4 of its max |g| (products summed in another order than
XLA's: measured ~1e-6); AdamW fed identical gradients and state within
1e-6 of each leaf's max |.|; a whole step's parameter update (new minus
old) within 1e-4 of each leaf's max update (the gradients' ~1e-6
differences, divided by sqrt(v), which is small for some elements).  At
``grad_bits=8`` the quantized gradients are compared as ``q``: where the
two packages' float32 gradients straddle a rounding boundary ``q`` moves
by one step; the count of such elements is held under 1e-3 of all (the
bound ``tests/test_kernels.py`` sets for the Pallas kernel is 1e-2).
The steps use ``learning_rate=1e-2`` and no warmup, so an update is far
above the float32 rounding of the parameters.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import approx_comm as TAC  # noqa: E402
from repro_torch.data.pipeline import Prefetcher, TokenStream  # noqa: E402
from repro_torch.kernels import quantize as TQ  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

B, S = 4, 32
LR = dict(learning_rate=1e-2, warmup_steps=1)
LOSS_RTOL, GRAD_TOL, ADAMW_TOL, UPDATE_TOL = 1e-5, 1e-4, 1e-6, 1e-4
Q_MOVED_MAX = 1e-3


def share(got, want):
    """max |got - want| as a share of max |want| (0 when both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    top = np.abs(want).max()
    d = np.abs(got - want).max()
    return float(d / top) if top else float(d)


def items(tree):
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v) for k, v in tree_items(tree)}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's training pieces, with any mesh a test before left
    active switched off (``launch/steps.py`` activates one)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.approx_comm import make_grad_compressor
    from repro.data.pipeline import TokenStream as JTokenStream
    from repro.models.registry import build_model
    from repro.optim import adamw
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    return dict(jax=jax, jnp=jnp, get_config=get_config,
                build_model=build_model, adamw=adamw,
                make_grad_compressor=make_grad_compressor,
                TokenStream=JTokenStream)


def jax_cfg(jx, mb):
    return dataclasses.replace(jx["get_config"]("qwen3-1.7b").reduced(),
                               train_microbatches=mb)


def port_cfg(mb):
    return dataclasses.replace(t_get_config("qwen3-1.7b").reduced(),
                               train_microbatches=mb)


def jax_step(jx, cfg, params, state, batch, bits):
    """The JAX ``train_step`` composed from its pieces (sharding off);
    returns (new params, new state, loss, raw grads, hooked grads)."""
    jax, jnp = jx["jax"], jx["jnp"]
    model = jx["build_model"](cfg)
    mb = cfg.train_microbatches
    bb = {k: jnp.asarray(v) for k, v in batch.items()}
    if mb == 1:
        loss, grads = jax.value_and_grad(model.loss_fn)(params, bb)
    else:
        mbs = jax.tree_util.tree_map(
            lambda x: x.reshape(mb, x.shape[0] // mb, *x.shape[1:]), bb)

        def one(carry, m):
            loss_sum, acc = carry
            l, g = jax.value_and_grad(model.loss_fn)(params, m)
            acc = jax.tree_util.tree_map(
                lambda a, gg: a + gg.astype(jnp.float32), acc, g)
            return (loss_sum + l, acc), None

        acc0 = jax.tree_util.tree_map(
            lambda p: jnp.zeros(p.shape, jnp.float32), params)
        (loss_sum, grads), _ = jax.lax.scan(
            one, (jnp.zeros((), jnp.float32), acc0), mbs)
        loss = loss_sum / mb
        grads = jax.tree_util.tree_map(lambda g: g / mb, grads)
    hooked = (jx["make_grad_compressor"](bits, min_size=1024)(grads)
              if bits < 16 else grads)
    new_p, new_s = jx["adamw"].adamw_update(
        jx["adamw"].AdamWConfig(**LR), params, hooked, state)
    return new_p, new_s, loss, grads, hooked


@pytest.fixture(scope="module")
def mid(jx):
    """A mid-training state of the reduced JAX qwen3: parameters and AdamW
    state after two JAX steps (one microbatch, no compression), and the
    third batch of the JAX ``TokenStream``, all as NumPy."""
    jax = jx["jax"]
    cfg = jax_cfg(jx, 1)
    params = jx["build_model"](cfg).init_params(jax.random.PRNGKey(0))
    state = jx["adamw"].init_opt_state(params)
    stream = jx["TokenStream"](cfg.vocab_size, B, S, seed=0)
    for _ in range(2):
        params, state, *_ = jax_step(jx, cfg, params, state,
                                     stream.next_batch(), 16)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return as_np(params), as_np(state), stream.next_batch()


def port_state(mb, mid):
    params, state, _ = mid
    cfg = port_cfg(mb)
    return (cfg, convert.model_params_from_numpy(cfg, params, device="cpu"),
            convert.opt_state_from_numpy(cfg, state, device="cpu"))


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- the loss and its gradients ---------------------------------------------


@pytest.mark.parametrize("mb", [1, 2])
def test_loss_and_grads_match_jax(jx, mid, mb):
    """The microbatch-summed loss and float32 gradients of the port's
    ``compute_grads`` against JAX's value_and_grad (and its scan)."""
    params, state, batch = mid
    _, _, jloss, jgrads, _ = jax_step(
        jx, jax_cfg(jx, mb), *(jx["jax"].tree_util.tree_map(
            jx["jnp"].asarray, t) for t in (params, state)), batch, 16)
    cfg, tp, _ = port_state(mb, mid)
    loss, grads = TS.compute_grads(t_build(cfg), tp, tbatch(batch), mb)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = items(jx["jax"].tree_util.tree_map(np.asarray, jgrads))
    got = items(grads)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        assert share(got[k], want[k]) <= GRAD_TOL, k


def test_loss_fn_matches_jax(jx, mid):
    params, _, batch = mid
    jcfg = jax_cfg(jx, 1)
    jloss = jx["build_model"](jcfg).loss_fn(
        jx["jax"].tree_util.tree_map(jx["jnp"].asarray, params),
        {k: jx["jnp"].asarray(v) for k, v in batch.items()})
    cfg, tp, _ = port_state(1, mid)
    loss = t_build(cfg).loss_fn(tp, tbatch(batch))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))


def test_loss_masks_negative_labels(jx, mid):
    """Positions with ``labels < 0`` leave the mean, as in JAX."""
    params, _, batch = mid
    labels = batch["labels"].copy()
    labels[:, ::3] = -1
    masked = dict(batch, labels=labels)
    jloss = jx["build_model"](jax_cfg(jx, 1)).loss_fn(
        jx["jax"].tree_util.tree_map(jx["jnp"].asarray, params),
        {k: jx["jnp"].asarray(v) for k, v in masked.items()})
    cfg, tp, _ = port_state(1, mid)
    loss = t_build(cfg).loss_fn(tp, tbatch(masked))
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))


def test_remat_gives_the_same_grads(mid):
    """Recomputing each block in the backward pass changes nothing."""
    cfg, tp, _ = port_state(1, mid)
    batch = tbatch(mid[2])
    _, g_full = TS.compute_grads(t_build(cfg), tp, batch, 1)
    _, g_none = TS.compute_grads(
        t_build(dataclasses.replace(cfg, remat="none")), tp, batch, 1)
    for k, v in items(g_full).items():
        np.testing.assert_array_equal(v, items(g_none)[k])


# -- AdamW --------------------------------------------------------------------


def test_adamw_update_from_carried_state_matches_jax(jx, mid):
    """The same gradients and mid-training state through both AdamWs."""
    jax, jnp = jx["jax"], jx["jnp"]
    params, state, _ = mid
    rng = np.random.default_rng(3)
    grads = jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32),
        params)
    jp, js = jx["adamw"].adamw_update(
        jx["adamw"].AdamWConfig(**LR), *(jax.tree_util.tree_map(
            jnp.asarray, t) for t in (params, grads, state)))
    cfg, tp, ts = port_state(1, mid)
    tg = convert.model_params_from_numpy(cfg, grads, device="cpu")
    pp, ps = TO.adamw_update(TO.AdamWConfig(**LR), tp, tg, ts)
    assert int(ps["count"]) == int(js["count"]) == 3
    for got, want in ((pp, jp), (ps["m"], js["m"]), (ps["v"], js["v"])):
        want = items(jax.tree_util.tree_map(np.asarray, want))
        got = items(got)
        for k in want:
            assert share(got[k], want[k]) <= ADAMW_TOL, k


def test_adamw_writes_in_place(mid):
    """The new parameters and moments land in the tensors passed in (the
    JAX step donates them)."""
    cfg, tp, ts = port_state(1, mid)
    g = {k: v for k, v in tp.items()}
    embed, m_embed = tp["embed"], ts["m"]["embed"]
    before = embed.clone()
    pp, ps = TO.adamw_update(TO.AdamWConfig(**LR), tp, g, ts)
    assert pp["embed"] is embed and ps["m"]["embed"] is m_embed
    assert not torch.equal(embed, before)


def test_adamw_quadratic_converges():
    cfg = TO.AdamWConfig(learning_rate=0.1, weight_decay=0.0, warmup_steps=1)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = TO.init_opt_state(params, device="cpu")
    for _ in range(150):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad((w ** 2).sum(), w)
        params, state = TO.adamw_update(cfg, params, {"w": g}, state)
    assert float((params["w"] ** 2).sum()) < 1e-3


def test_adamw_grad_clip_bounds_update():
    cfg = TO.AdamWConfig(learning_rate=1.0, grad_clip=1e-3, warmup_steps=1,
                         weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = TO.init_opt_state(params, device="cpu")
    new, _ = TO.adamw_update(cfg, params, {"w": torch.full((4,), 1e9)},
                             state)
    assert float(new["w"].abs().max()) < 2.0


def test_adamw_weight_decay_on_matrices_only():
    cfg = TO.AdamWConfig(learning_rate=0.01, weight_decay=0.5,
                         warmup_steps=1)
    params = {"mat": torch.ones((4, 4)), "vec": torch.ones(4)}
    state = TO.init_opt_state(params, device="cpu")
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    new, _ = TO.adamw_update(cfg, params, zeros, state)
    assert float(new["mat"][0, 0]) < 1.0
    np.testing.assert_allclose(new["vec"].numpy(), 1.0)


# -- one whole step ----------------------------------------------------------


def q_moved(got, want, bits):
    """Quantize both float32 gradient leaves (the same quantizer on each
    package's own gradients) and return (max |dq|, a mask of the elements
    whose q moved, in the leaf's shape)."""
    qs = []
    for g in (got, want):
        x2d, n = TAC._pad_2d(torch.from_numpy(np.array(g)))
        q, _ = TQ.quantize_blocks_plain(x2d, bits=bits)
        qs.append(q.reshape(-1)[:n].reshape(g.shape).int())
    d = (qs[0] - qs[1]).abs()
    return int(d.max()), (d != 0).numpy()


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_jax(jx, mid, mb, bits):
    """One step from the carried-over mid-training state: the loss, the
    quantized gradients (as q) and every parameter's update.  At bits 8 an
    element whose q moved by one step takes a gradient one quantization
    step apart, and so another update: those elements are counted (under
    ``Q_MOVED_MAX`` of all) and left out of the update's comparison; every
    other element is held to ``UPDATE_TOL``."""
    jax, jnp = jx["jax"], jx["jnp"]
    params, state, batch = mid
    jp, _, jloss, jgrads, _ = jax_step(
        jx, jax_cfg(jx, mb), *(jax.tree_util.tree_map(jnp.asarray, t)
                               for t in (params, state)), batch, bits)
    cfg, tp, ts = port_state(mb, mid)
    hook = TAC.make_grad_compressor(bits, min_size=1024)
    step = TS.build_train_step(cfg, TO.AdamWConfig(**LR), hook)
    # the raw gradients too, for the q comparison
    _, tgrads = TS.compute_grads(t_build(cfg), tp, tbatch(batch), mb)
    new_p, new_s, metrics = step(tp, ts, tbatch(batch))
    assert abs(float(metrics["loss"]) - float(jloss)) \
        <= LOSS_RTOL * abs(float(jloss))
    assert int(new_s["count"]) == 3
    want_p = items(jax.tree_util.tree_map(np.asarray, jp))
    got_p = items(new_p)
    old = items(params)
    want_g = items(jax.tree_util.tree_map(np.asarray, jgrads))
    got_g = items(tgrads)
    moved = total = 0
    for k in want_p:
        keep = np.ones(want_p[k].shape, bool)
        if bits < 16 and want_g[k].size >= 1024:
            dmax, mask = q_moved(got_g[k], want_g[k], bits)
            assert dmax <= 1, k
            moved += int(mask.sum())
            total += mask.size
            keep = ~mask
        du_got, du_want = got_p[k] - old[k], want_p[k] - old[k]
        assert np.isfinite(du_got).all(), k
        assert share(du_got[keep], du_want[keep]) <= UPDATE_TOL, k
    assert moved <= Q_MOVED_MAX * max(total, 1)


def test_hook_leaves_small_leaves_alone():
    grads = {"big": torch.full((512, 512), 0.37), "small": torch.full((4,),
                                                                       0.37)}
    out = TAC.make_grad_compressor(8, min_size=1024)(grads)
    assert out["small"] is grads["small"]
    assert float((out["big"] - 0.37).abs().max()) < 0.37 / 127


def test_microbatch_rule():
    cfg = port_cfg(4)
    assert [TS.microbatch_count(cfg, b) for b in (8, 6, 5, 4, 1)] == \
        [4, 3, 1, 4, 1]
    assert TS.microbatch_count(cfg, 8, dp_size=4) == 2


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 2, 32, 3),
                                                  (151936, 2, 64, 0)])
def test_token_stream_matches_jax(jx, vocab, batch, seq, seed):
    a = TokenStream(vocab, batch, seq, seed=seed)
    b = jx["TokenStream"](vocab, batch, seq, seed=seed)
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(x[k], y[k])
            assert x[k].dtype == y[k].dtype


def test_prefetcher_order_and_errors():
    assert list(Prefetcher(iter(range(10)), depth=3)) == list(range(10))

    def gen():
        yield 1
        raise RuntimeError("boom")

    pf = Prefetcher(gen(), depth=2)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)


# -- checkpoints --------------------------------------------------------------


def _tree(x=0.0):
    return {"a": {"w": torch.full((8, 8), 1.0 + x)},
            "b": torch.arange(16, dtype=torch.float32) + x,
            "h": torch.full((3, 5), 0.1 + x, dtype=torch.bfloat16)}


def test_checkpoint_roundtrip_with_bf16(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree(1.0)
    ck.save(5, tree, meta={"loss": 3.0})
    restored, step = ck.restore(_tree(), device="cpu")
    assert step == 5
    assert restored["h"].dtype == torch.bfloat16
    for k, v in tree_items(tree):
        assert torch.equal(dict(tree_items(restored))[k], v), k


def test_checkpoint_layout(tmp_path):
    """The JAX layout: one ``.npy`` per flat key beside a manifest."""
    import json
    import os
    ck = Checkpointer(str(tmp_path))
    ck.save(2, _tree())
    d = tmp_path / "step_00000002"
    names = sorted(os.listdir(d))
    assert names == ["MANIFEST.json", "a__w.npy", "b.npy", "h.npy"]
    man = json.loads((d / "MANIFEST.json").read_text())
    assert man["keys"] == ["a/w", "b", "h"] and man["dtypes"]["h"] == \
        "bfloat16"


def test_checkpoint_corruption_falls_back(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1.0))
    ck.save(2, _tree(2.0))
    ck.corrupt(2)
    assert ck.latest_valid_step() == 1
    restored, step = ck.restore(_tree(), device="cpu")
    assert step == 1 and float(restored["b"][0]) == 1.0


def test_checkpoint_keeps_last_k(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in range(5):
        ck.save(s, _tree(float(s)))
    assert ck.steps() == [3, 4]


def test_checkpoint_save_async(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree(7.0)
    t = ck.save_async(7, tree)
    tree["b"].fill_(-1.0)          # training goes on writing its tensors
    t.join(timeout=30)
    assert not t.is_alive()
    assert ck.latest_valid_step() == 7
    restored, _ = ck.restore(_tree(), device="cpu")
    assert float(restored["b"][0]) == 7.0


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"b": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore({"b": torch.zeros(5)}, device="cpu")


def test_checkpoint_restores_a_jax_bf16_checkpoint(jx, tmp_path):
    """A reduced ``qwen3-1.7b`` parameter tree cast to bfloat16 and saved
    by the JAX package's Checkpointer (no dtypes in its manifest; bfloat16
    leaves as ``|V2`` records) restores through the port's into the port's
    bfloat16 tree, every leaf equal bit for bit to the JAX leaf."""
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    jax, jnp = jx["jax"], jx["jnp"]
    cfg = jax_cfg(jx, 1)
    params = jx["build_model"](cfg).init_params(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                    params)
    JCheckpointer(str(tmp_path)).save(3, params)
    host = jax.tree_util.tree_map(np.asarray, params)
    target = convert.model_params_from_numpy(port_cfg(1), host,
                                             device="cpu")
    restored, step = Checkpointer(str(tmp_path)).restore(target,
                                                         device="cpu")
    assert step == 3
    want = {k: v.view(np.uint16) for k, v in tree_items(host)}
    got = dict(tree_items(restored))
    assert sorted(got) == sorted(want) and len(got) > 5
    for key, leaf in got.items():
        assert leaf.dtype == torch.bfloat16, key
        assert np.array_equal(leaf.view(torch.int16).numpy().view(np.uint16),
                              want[key]), key


def test_checkpoint_void_leaf_into_non_bf16_target_raises(jx, tmp_path):
    """A 2-byte void leaf (a JAX bfloat16 save) is bfloat16 bits only for
    a bfloat16 target; a float32 target raises instead of guessing."""
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    jnp = jx["jnp"]
    JCheckpointer(str(tmp_path)).save(
        1, {"w": jnp.ones((4, 4), jnp.bfloat16)})
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(ValueError, match="bfloat16 target"):
        ck.restore({"w": torch.zeros(4, 4)}, device="cpu")
    restored, _ = ck.restore({"w": torch.zeros(4, 4, dtype=torch.bfloat16)},
                             device="cpu")
    assert torch.equal(restored["w"], torch.ones(4, 4, dtype=torch.bfloat16))


# -- train() (tests/test_train_e2e.py::TestTraining on the CPU) --------------


def test_train_loss_decreases(tmp_path):
    out = train("qwen3-1.7b", steps=25, batch=4, seq=64,
                checkpoint_dir=str(tmp_path), checkpoint_every=10,
                log_every=1000, device="cpu")
    assert out["device"] == "cpu" and len(out["losses"]) == 25
    assert out["final_loss"] < out["first_loss"]


def test_train_failure_injection_recovers_from_checkpoint(tmp_path):
    out = train("qwen3-1.7b", steps=30, batch=4, seq=64,
                checkpoint_dir=str(tmp_path), checkpoint_every=10,
                inject_failure_at=22, log_every=1000, device="cpu")
    # recovery rewound to step 20's checkpoint and completed the run
    assert out["recoveries"] == [(22, 20)]
    assert out["final_loss"] is not None
    assert len(out["losses"]) == 22 + (30 - 20)
    assert np.isfinite(out["losses"]).all()


def test_train_compressed_grads_train():
    out = train("qwen3-1.7b", steps=15, batch=4, seq=64, grad_bits=8,
                log_every=1000, device="cpu")
    assert out["final_loss"] < out["first_loss"]


def test_train_refuses_a_mesh():
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1, fleet mesh and sharding"):
        train("qwen3-1.7b", steps=1, mesh_shape=(1, 1), device="cpu")


def test_kernel_attention_refuses_autograd(mid):
    """The flash kernel has no backward: training through it raises, on
    the CPU too, instead of differentiating the plain version."""
    cfg, tp, _ = port_state(1, mid)
    cfg = dataclasses.replace(cfg, attention_impl="kernel")
    with pytest.raises(NotImplementedError, match="no backward"):
        TS.compute_grads(t_build(cfg), tp, tbatch(mid[2]), 1)


def test_remat_dots_is_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_build(dataclasses.replace(port_cfg(1), remat="dots"))


def test_ssm_training_is_not_ported():
    cfg = t_get_config("rwkv6-1.6b").reduced()
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1, rwkv6 training"):
        t_build(cfg).loss_fn({}, {})
