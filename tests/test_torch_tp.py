"""Tensor-parallel compute of the attention families over four gloo ranks,
held against the JAX package's unsharded model, on the CPU.

The four ranks are spawned once for the module (``torch.multiprocessing``,
a ``FileStore`` under the module's temporary directory) and run every case
in one process group, on the meshes ``(1, 4)`` and ``(2, 2)`` (``("data",
"model")``).  The configs, reduced: ``qwen3-1.7b`` (4 query and 2 KV heads:
at model axis 4 each rank holds half a KV head, gathered before
attention); ``phi3-medium-14b`` with 6 query and 3 KV heads (the query
heads do not divide the model axis: every rank computes every head and
keeps its columns for ``wo``, phi3-medium's 40 heads over 16 ranks), and
the same under the ``sequence_parallel`` hint (its specs then leave the
attention weights whole where the heads do not divide the axis: every
rank gathers nothing and computes the attention alike);
``moonshot-v1-16b-a3b`` under ``moe_parallel="ep"`` (two or four experts a
rank) and ``"tp"`` (each expert's ``F`` split); ``qwen2-vl-72b`` (16 patch
embeddings before 8 text tokens, M-RoPE).

Each config's weights come from the JAX package's ``init_params``, as NumPy,
through ``convert.model_params_from_numpy``; the inputs are drawn with
NumPy from a seed.  Each rank runs the steps ``launch/steps.py`` builds on
its ``DeviceMesh`` over its blocks: a prefill of 4 prompts of 24 positions
into a cache of 40 rows (its sequence axis on the model axis: 10 or 20
rows a rank, so at model axis 4 the last rank holds no valid row during
the decode steps), 3 decode steps, and one training step (AdamW at
``warmup_steps=0``, so the step moves every parameter).  Held against the
JAX package's unsharded functions (``repro.sharding.api.deactivate()``
first) on the rank's blocks: the prefill logits (the rank's rows and
vocabulary columns) and the cache rows it wrote, every decode step's
logits and the rows written, the training loss and every updated
parameter block -- all in float32 within rtol/atol ``TOL`` = 2e-4, the
transformer tests' bound.  Also: each rank's weights hold ``1/m`` of every
attention and FFN weight's model dimension (the bundle's local shapes);
``build_sharded_grads`` of these families never calls ``spmd.full_tree``;
and a planted fault -- rank 1 keeping its own partial ``wo`` product in
place of the all-reduced sum -- must move the logits past ``TOL``.
"""

import dataclasses
import datetime
import logging
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.sharding import partition as TP  # noqa: E402

WORLD = 4
TOL = 2e-4
B, S, S_MAX, STEPS = 4, 24, 40, 3
CONFIGS = {
    "qwen3": ("qwen3-1.7b", {}),
    "heads6x3": ("phi3-medium-14b", {"num_heads": 6, "num_kv_heads": 3}),
    "heads6x3-sp": ("phi3-medium-14b", {"num_heads": 6, "num_kv_heads": 3,
                                        "sequence_parallel": True}),
    "moonshot-ep": ("moonshot-v1-16b-a3b", {"moe_parallel": "ep"}),
    "moonshot-tp": ("moonshot-v1-16b-a3b", {"moe_parallel": "tp"}),
    "qwen2-vl": ("qwen2-vl-72b", {}),
}
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
AXES = ("data", "model")
TIMEOUT_S = 300


def _seed(name: str) -> int:
    """One seed an arch: the cases of one arch share weights and inputs,
    and so one JAX reference (``moe_parallel`` and ``sequence_parallel``
    place blocks; the unsharded JAX model computes the same function under
    any of them)."""
    return sorted({a for a, _ in CONFIGS.values()}).index(CONFIGS[name][0])


def _port_cfg(name: str):
    arch, changes = CONFIGS[name]
    return dataclasses.replace(get_config(arch).reduced(), **changes)


def _inputs(name: str) -> dict:
    """The case's inputs as NumPy, from a seed: the prompt batch, the
    decode tokens and the training batch."""
    cfg = _port_cfg(name)
    rng = np.random.default_rng(_seed(name))
    vlm = cfg.family == "vlm"
    text = S - cfg.frontend_tokens if vlm else S

    def batch(train: bool) -> dict:
        out = {"tokens": rng.integers(0, cfg.vocab_size, (B, text),
                                      dtype=np.int32)}
        if vlm:
            out["patch_embeds"] = (0.02 * rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
        if train:
            out["labels"] = rng.integers(0, cfg.vocab_size, (B, text),
                                         dtype=np.int32)
        return out
    return {"prompt": batch(False), "train": batch(True),
            "tokens": [rng.integers(0, cfg.vocab_size, (B, 1),
                                    dtype=np.int32) for _ in range(STEPS)]}


def _blocks(tree, specs, mesh, coord):
    """The blocks of a whole tree (tensors in dicts and dataclasses) at
    mesh coordinate ``coord``, per ``specs``."""
    if isinstance(tree, dict):
        return {k: _blocks(v, specs[k], mesh, coord) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _blocks(getattr(tree, f.name), getattr(specs, f.name),
                            mesh, coord) for f in dataclasses.fields(tree)})
    if not isinstance(tree, torch.Tensor):
        return tree
    return TP.NamedSharding(mesh, specs).local_block(tree, coord).clone()


def _faulty_wo(orig):
    """``_attention_tp`` with its ``wo`` all-reduce's result dropped: the
    rank takes part in the collective but keeps its own partial sum."""
    from repro_torch.models import transformer as T

    def run(*args, **kwargs):
        real = T.C
        shim = types.SimpleNamespace(**{n: getattr(real, n) for n in
                                        real.__all__})
        shim.reduce_from = lambda x, group: (real.reduce_from(x, group), x)[1]
        T.C = shim
        try:
            return orig(*args, **kwargs)
        finally:
            T.C = real
    return run


def _run_case(name: str, shape: tuple, tree: dict, inputs: dict, *,
              fault: bool = False) -> dict:
    """One rank's prefill, decode steps and training step of one case."""
    from repro_torch.launch import steps as S_
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    cfg = _port_cfg(name)
    mesh = make_mesh(shape, AXES, device_type="cpu")
    coord = tuple(mesh.get_coordinate())
    model = R.build_model(cfg)
    params = convert.model_params_from_numpy(cfg, tree, device="cpu")
    as_t = {k: torch.from_numpy(v) for k, v in inputs["prompt"].items()}
    prefill = S_.build_prefill_step(cfg, ShapeCell("tp", S, B, "prefill"),
                                    mesh=mesh, device="cpu")
    serve = S_.build_serve_step(cfg, ShapeCell("tp", S, B, "decode"),
                                mesh=mesh, device="cpu")
    whole_cache = model.init_cache(B, S_MAX, device="cpu")
    cspecs = TP.cache_specs(whole_cache, cfg, mesh)
    cache = _blocks(whole_cache, cspecs, mesh, coord)
    lp = _blocks(params, prefill.in_shardings[0], mesh, coord)
    out = {"coord": coord,
           "shapes": {k: tuple(prefill.arg_specs[0]["layers"][k].shape)
                      for k in ("wq", "wk", "wv", "wo")}}
    orig = T._attention_tp
    if fault and dist.get_rank() == 1:
        T._attention_tp = _faulty_wo(orig)
    try:
        with torch.no_grad():
            logits, cache = prefill.fn(
                lp, _blocks(as_t, prefill.in_shardings[1], mesh, coord),
                cache)
            out["prefill"] = logits
            out["prefill_k"] = cache.k.clone()
            if fault:
                return out
            out["decode"] = []
            for tok in inputs["tokens"]:
                logits, cache = serve.fn(
                    lp, _blocks(torch.from_numpy(tok),
                                serve.in_shardings[1], mesh, coord), cache)
                out["decode"].append(logits)
            out["cache_k"], out["cache_v"] = cache.k, cache.v
    finally:
        T._attention_tp = orig
    opt = AdamWConfig(warmup_steps=0)
    train = S_.build_train_bundle(cfg, ShapeCell("tp", S, B, "train"),
                                  mesh=mesh, device="cpu", opt=opt)
    state = init_opt_state(params, device="cpu")
    lo = {"m": _blocks(state["m"], train.in_shardings[1]["m"], mesh, coord),
          "v": _blocks(state["v"], train.in_shardings[1]["v"], mesh, coord),
          "count": state["count"]}
    tb = {k: torch.from_numpy(v) for k, v in inputs["train"].items()}
    new, _, metrics = train.fn(
        _blocks(params, train.in_shardings[0], mesh, coord), lo,
        _blocks(tb, train.in_shardings[2], mesh, coord))
    out["loss"], out["params"] = float(metrics["loss"]), new
    return out


def _grads_without_full_tree(root: str) -> None:
    """``build_sharded_grads`` of reduced qwen3 on ``(2, 2)`` with
    ``spmd.full_tree`` made to raise."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_sharded_grads
    from repro_torch.models import registry as R
    from repro_torch.sharding import spmd
    cfg = _port_cfg("qwen3")
    mesh = make_mesh((2, 2), AXES, device_type="cpu")
    g = torch.Generator()
    g.manual_seed(0)
    params = R.build_model(cfg).init_params(g, device="cpu")
    batch = R.make_batch(cfg, B, 8, generator=g, device="cpu", train=True)
    shardings = TP.logical_to_sharding(
        TP.param_specs(R.param_specs(cfg), cfg, mesh), mesh)
    sharded = spmd.shard_tree(params, shardings)
    real = spmd.full_tree

    def refuse(tree):
        raise AssertionError("full_tree on the partitioned path")
    spmd.full_tree = refuse
    try:
        loss, _ = build_sharded_grads(cfg, mesh)(sharded, batch)
    finally:
        spmd.full_tree = real
    torch.save(float(loss), os.path.join(root,
                                         f"nofull-{dist.get_rank()}.pt"))


def _rank_main(rank: int, root: str) -> None:
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"), WORLD),
        rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=120))
    try:
        data = torch.load(os.path.join(root, "data.pt"), weights_only=False)
        for name in CONFIGS:
            for label, shape in MESHES.items():
                torch.save(_run_case(name, shape, *data[name]),
                           os.path.join(root, f"{name}-{label}-{rank}.pt"))
        torch.save(_run_case("qwen3", MESHES["1x4"], *data["qwen3"],
                             fault=True),
                   os.path.join(root, f"fault-{rank}.pt"))
        _grads_without_full_tree(root)
    finally:
        dist.destroy_process_group()


def _jax_reference(jax, jnp, JR, adamw, cfg, tree: dict, inputs: dict
                   ) -> dict:
    """The JAX package's unsharded run of one case from its NumPy weights
    and inputs: prefill, decode steps and one training step."""
    model = JR.build_model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    prompt = {k: jnp.asarray(v) for k, v in inputs["prompt"].items()}
    cache = model.init_cache(B, S_MAX)
    logits, cache = jax.jit(model.prefill)(params, prompt, cache)
    want = {"prefill": np.asarray(logits), "prefill_k": np.asarray(cache.k),
            "decode": []}
    decode = jax.jit(model.decode_step)
    for tok in inputs["tokens"]:
        logits, cache = decode(params, jnp.asarray(tok), cache)
        want["decode"].append(np.asarray(logits))
    want["cache_k"], want["cache_v"] = np.asarray(cache.k), \
        np.asarray(cache.v)
    train = {k: jnp.asarray(v) for k, v in inputs["train"].items()}
    loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(params, train)
    new, _ = adamw.adamw_update(adamw.AdamWConfig(warmup_steps=0), params,
                                grads, adamw.init_opt_state(params))
    want["loss"] = float(loss)
    want["params"] = jax.tree_util.tree_map(np.asarray, new)
    return want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references (computed while the four ranks run) and a loader
    of the ranks' results."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import registry as JR
    from repro.optim import adamw
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    root = str(tmp_path_factory.mktemp("tp"))
    cfgs, data, wants, by_seed = {}, {}, {}, {}
    for name in CONFIGS:
        cfgs[name] = dataclasses.replace(jget(CONFIGS[name][0]).reduced(),
                                         **CONFIGS[name][1])
        params = JR.build_model(cfgs[name]).init_params(
            jax.random.PRNGKey(_seed(name)))
        data[name] = (jax.tree_util.tree_map(np.asarray, params),
                      _inputs(name))
    torch.save(data, os.path.join(root, "data.pt"))
    ctx = mp.start_processes(_rank_main, args=(root,), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=TIMEOUT_S)
    try:
        for name in CONFIGS:
            if _seed(name) not in by_seed:
                by_seed[_seed(name)] = _jax_reference(
                    jax, jnp, JR, adamw, cfgs[name], *data[name])
            wants[name] = by_seed[_seed(name)]
        while not ctx.join(timeout=2):
            if datetime.datetime.now() > deadline:
                pytest.fail(f"the ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        shard_api.deactivate()
    return wants, lambda tag, rank: torch.load(
        os.path.join(root, f"{tag}-{rank}.pt"), weights_only=False)


def _block_of(want: np.ndarray, spec, shape: tuple, coord: tuple
              ) -> np.ndarray:
    mesh = TP.AbstractMesh(shape, AXES)
    return TP.NamedSharding(mesh, spec).local_block(
        torch.from_numpy(np.array(want)), coord).numpy()


def _close(got, want: np.ndarray) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=TOL, atol=TOL)


def _specs(name: str, shape: tuple):
    cfg = _port_cfg(name)
    mesh = TP.AbstractMesh(shape, AXES)
    from repro_torch.models import registry as R
    pspecs = TP.param_specs(R.param_specs(cfg), cfg, mesh)
    cache = R.build_model(cfg).init_cache(B, S_MAX, device="meta")
    return (cfg, pspecs, TP.cache_specs(cache, cfg, mesh),
            TP.logits_spec((B, 1, cfg.padded_vocab), cfg, mesh))


CASES = [(n, m) for n in CONFIGS for m in MESHES]
IDS = [f"{n}-{m}" for n, m in CASES]


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_prefill_and_decode_match_jax(runs, name, mesh):
    wants, load = runs
    want = wants[name]
    shape = MESHES[mesh]
    cfg, _, cspecs, lspec = _specs(name, shape)
    for rank in range(WORLD):
        got = load(f"{name}-{mesh}", rank)
        coord = got["coord"]
        last = want["prefill"][:, -1:]
        _close(got["prefill"], _block_of(last, lspec, shape, coord))
        _close(got["prefill_k"], _block_of(want["prefill_k"], cspecs.k,
                                           shape, coord))
        for g, w in zip(got["decode"], want["decode"], strict=True):
            _close(g, _block_of(w, lspec, shape, coord))
        for key in ("cache_k", "cache_v"):
            _close(got[key], _block_of(want[key], getattr(cspecs, key[-1]),
                                       shape, coord))


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_train_step_matches_jax(runs, name, mesh):
    from repro_torch.tree import tree_items
    wants, load = runs
    want = wants[name]
    shape = MESHES[mesh]
    _, pspecs, _, _ = _specs(name, shape)
    specs = dict(tree_items(pspecs))
    wanted = dict(tree_items(want["params"]))
    for rank in range(WORLD):
        got = load(f"{name}-{mesh}", rank)
        assert abs(got["loss"] - want["loss"]) <= TOL * (1 + abs(
            want["loss"]))
        items = tree_items(got["params"])
        assert [k for k, _ in items] == sorted(wanted)
        for key, g in items:
            _close(g, _block_of(wanted[key], specs[key], shape,
                                got["coord"]))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_weights_hold_their_model_axis_share(runs, mesh):
    """Each rank's ``wq``/``wk``/``wv`` hold ``1/m`` of their output
    columns and ``wo`` of its input rows (and ``1/dp`` of ``d_model``) --
    whole under the ``sequence_parallel`` hint where the heads do not
    divide the model axis."""
    _, load = runs
    dp, m = MESHES[mesh]
    for name in CONFIGS:
        cfg = _port_cfg(name)
        n, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim
        qh, kh = cfg.num_heads * hd, cfg.num_kv_heads * hd
        ma = 1 if cfg.sequence_parallel and cfg.num_heads % m else m
        want = {"wq": (n, d // dp, qh // ma), "wk": (n, d // dp, kh // ma),
                "wv": (n, d // dp, kh // ma), "wo": (n, qh // ma, d // dp)}
        for rank in range(WORLD):
            assert load(f"{name}-{mesh}", rank)["shapes"] == want, name


def test_sharded_grads_take_no_full_tree(runs):
    _, load = runs
    losses = [load("nofull", rank) for rank in range(WORLD)]
    assert all(np.isfinite(losses)) and len(set(losses)) == 1


def test_a_rank_that_keeps_its_partial_wo_product_fails(runs):
    """Rank 1 keeping its own ``wo`` partial sum fails the prefill check
    that ``test_prefill_and_decode_match_jax`` makes."""
    wants, load = runs
    shape = MESHES["1x4"]
    _, _, _, lspec = _specs("qwen3", shape)
    got = load("fault", 1)
    block = _block_of(wants["qwen3"]["prefill"][:, -1:], lspec, shape,
                      got["coord"])
    with pytest.raises(AssertionError):
        _close(got["prefill"], block)
    assert float(np.abs(got["prefill"].numpy() - block).max()) > 10 * TOL
