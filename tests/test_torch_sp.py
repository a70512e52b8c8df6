"""Sequence-parallel compute under the ``sequence_parallel`` hint, over
four gloo ranks, held against the JAX package's unsharded model on the
CPU.

Under the hint JAX constrains the transformer's residual stream to
``shard(h, "dp", "model", None)`` at the embedding and after every block:
the sequence lies on the model axis between blocks (Megatron's sequence
parallelism).  The port's rank holds its ``S/m`` rows there, gathers them
into each column-parallel block (``gather_summed``) and reduce-scatters
each row-parallel block's sums back to them (``scatter_from``).

The four ranks are spawned once for the module (``torch.multiprocessing``,
a ``FileStore`` under the module's temporary directory), on the meshes
``(1, 4)`` and ``(2, 2)`` (``("data", "model")``).  The cases, reduced
(2 layers, ``d_model`` 64), all with the hint on:

  * ``qwen3`` (4 query and 2 KV heads: the heads divide the model axis);
  * ``heads6x3``: ``phi3-medium-14b`` with 6 query and 3 KV heads and
    ``d_ff`` 98 (at model axis 4 the specs leave the attention weights
    whole: every rank computes every head over the gathered rows and
    keeps its rows before ``wo``; and the FFN's, which then runs on the
    rank's rows; at 2 both split);
  * ``moonshot-ep``: ``moonshot-v1-16b-a3b`` under ``moe_parallel="ep"``
    (the router, the capacity and the auxiliary loss over every row); on
    ``(1, 4)`` also with 6 experts (left whole: every rank runs the whole
    FFN over the gathered rows) and with ``d_ff`` 98 (the shared expert
    left whole beside split experts, on the rank's rows);
  * ``qwen2-vl``: 16 patch rows and 8 tokens on ``(1, 4)``, the prompt
    with explicit M-RoPE positions (the patches on a 4 x 4 grid; the
    ranks take a batch's positions whole, so ``(2, 2)``'s data axis would
    split their rows from the tokens'; the training batch keeps the
    default ones, as a microbatch split cuts the positions' first dim);
  * ``qwen3-s22``: a prompt of 22 positions on ``(1, 4)``, which does not
    divide the model axis: the sequence stays whole, as JAX's ``shard``
    leaves it;
  * ``qwen3-zero3``: ``zero3`` on ``(2, 2)`` at B = 2 (the batch over the
    data axis, the sequence over the model axis, the weights gathered
    whole over both); at B = 4 the batch takes the model axis too and the
    step builders raise ``ValueError`` (JAX's ``DuplicateSpecError``).

Each case's weights come from the port's ``init_params`` drawn from a
seeded generator, as NumPy (the JAX functions take them as they are, each
rank through ``convert.model_params_from_numpy``); the inputs are drawn
with NumPy from a seed.  Each rank runs the steps ``launch/steps.py``
builds on its ``DeviceMesh``: a prefill of B prompts into a cache of
``S + DECODE_SLACK`` rows (the bundle's: 280 at S = 24, split over the
model axis; 278 at S = 22, whole), 3 decode steps, and one training step (AdamW at
``warmup_steps=0``).  Held against the JAX package's unsharded functions
(``repro.sharding.api.deactivate()`` first) on the rank's blocks: the
prefill logits and cache, each decode step's logits and the cache after
them, the training loss and every updated parameter block, within
rtol/atol ``TOL`` = 2e-4.  Also:

  * each rank's residual stream between layers holds S/m rows (a hook on
    the layer functions records the rows each sees);
  * ``rwkv6`` with the hint on is bitwise its run with the hint off (the
    hint never reaches it, as JAX's never does);
  * a planted fault moves qwen3's gradients past ``TOL``: every rank
    keeping ``copy_to`` in front of ``gather_summed`` at the FFN's entry,
    which counts the gradient of the FFN's input m times (every rank, so
    the collectives still pair up).

And without the ranks: the plain collectives stage a host copy only for
a card's tensor in a gloo group (``collectives.host_staged``).
"""

import dataclasses
import datetime
import logging
import os
from concurrent.futures import ThreadPoolExecutor

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
STEPS = 3
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
AXES = ("data", "model")
HINT = {"sequence_parallel": True}
# case -> (arch, config changes, meshes, batch, prompt length)
CONFIGS = {
    "qwen3": ("qwen3-1.7b", {}, ("1x4", "2x2"), 4, 24),
    "heads6x3": ("phi3-medium-14b", {"num_heads": 6, "num_kv_heads": 3,
                                      "d_ff": 98}, ("1x4", "2x2"), 4, 24),
    "moonshot-ep": ("moonshot-v1-16b-a3b", {"moe_parallel": "ep"},
                    ("1x4", "2x2"), 4, 24),
    # at model axis 4: 6 experts stay whole (every rank runs the whole
    # FFN over the gathered rows), and a shared expert 98 wide stays whole
    # beside split experts (it runs on the rank's rows)
    "moonshot-e6": ("moonshot-v1-16b-a3b", {"moe_parallel": "ep",
                                            "num_experts": 6}, ("1x4",),
                    4, 24),
    "moonshot-f98": ("moonshot-v1-16b-a3b", {"moe_parallel": "ep",
                                             "d_ff": 98}, ("1x4",), 4, 24),
    "qwen2-vl": ("qwen2-vl-72b", {}, ("1x4",), 4, 24),
    "qwen3-s22": ("qwen3-1.7b", {}, ("1x4",), 4, 22),
    "qwen3-zero3": ("qwen3-1.7b", {"zero3": True}, ("2x2",), 2, 24),
}
ZERO3_TAKES_MODEL = 4       # qwen3-zero3's batch that splits over both axes
TIMEOUT_S = 300
JAX_THREADS = 3


def _seed(name: str) -> int:
    """One seed an arch: the cases of one arch share their weights."""
    return sorted({a for a, *_ in CONFIGS.values()}).index(CONFIGS[name][0])


def _port_cfg(name: str, **more):
    arch, changes = CONFIGS[name][:2]
    return dataclasses.replace(get_config(arch).reduced(), **changes, **HINT,
                               **more)


def _grid_positions(b: int, s: int, patches: int) -> np.ndarray:
    """``[3, B, S]`` M-RoPE ids: the patches on a square grid, then the
    text from the largest id plus one in all three streams."""
    side = int(patches ** 0.5)
    i = np.arange(patches)
    patch = np.stack([np.zeros(patches), i // side, i % side])
    text = np.broadcast_to(patch.max() + 1 + np.arange(s - patches),
                           (3, s - patches))
    pos = np.concatenate([patch, text], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, s)))


def _inputs(name: str) -> dict:
    """The case's inputs as NumPy, from a seed: the prompt batch, the
    decode tokens and the training batch (no label masked: the step's
    microbatches average their own means, the JAX reference the batch's,
    which agree only where every microbatch counts as many labels)."""
    cfg = _port_cfg(name)
    _, _, _, b, s = CONFIGS[name]
    rng = np.random.default_rng(10 + list(CONFIGS).index(name))
    vlm = cfg.family == "vlm"

    def batch(train: bool) -> dict:
        text = s - cfg.frontend_tokens if vlm else s
        out = {"tokens": rng.integers(0, cfg.vocab_size, (b, text),
                                      dtype=np.int32)}
        if vlm:
            out["patch_embeds"] = (0.02 * rng.standard_normal(
                (b, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
        if vlm and not train:     # a microbatch split cuts dim 0, the
            # streams, as JAX's step's reshape does: the training batch
            # keeps the default positions
            out["positions"] = _grid_positions(b, s, cfg.frontend_tokens)
        if train:
            out["labels"] = rng.integers(0, cfg.vocab_size, (b, text),
                                         dtype=np.int32)
        return out
    return {"prompt": batch(False), "train": batch(True),
            "tokens": [rng.integers(0, cfg.vocab_size, (b, 1),
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


def _cache_pairs(cache, specs) -> list:
    """(tensor, spec) of a cache's tensor fields, nested dataclasses in
    field order (JAX's leaf order; its host ``length`` left out)."""
    out = []
    for f in dataclasses.fields(cache):
        x, sp = getattr(cache, f.name), getattr(specs, f.name)
        if dataclasses.is_dataclass(x):
            out += _cache_pairs(x, sp)
        elif isinstance(x, torch.Tensor):
            out.append((x, sp))
    return out


class RowHook:
    """A hook on the transformer's layer functions: the rows (dim 1) of
    the residual stream each call of ``_block`` (training) and
    ``attention_block`` / ``_ffn`` (prefill) takes and returns."""

    NAMES = ("_block", "attention_block", "_ffn")

    def __init__(self):
        self.rows = []

    def __enter__(self):
        from repro_torch.models import transformer as T
        self.saved = {n: getattr(T, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(T, n, self._wrap(fn))
        return self

    def _wrap(self, fn):
        def run(p, h, *args, **kwargs):
            out = fn(p, h, *args, **kwargs)
            y = out[0] if isinstance(out, tuple) else out
            self.rows.append((h.shape[1], y.shape[1]))
            return out
        return run

    def __exit__(self, *exc):
        from repro_torch.models import transformer as T
        for n, fn in self.saved.items():
            setattr(T, n, fn)


def _copy_then_gather(x, group, seq_dim):
    """``layers._ffn_entry`` with the fault planted: ``copy_to`` kept in
    front of ``gather_summed`` where the rows of a split sequence enter,
    so the backward pass all-reduces the gradient before reduce-scattering
    the sums again."""
    from repro_torch.sharding import collectives as C
    if group is None or seq_dim is None:
        return FAULT_ENTRY[0](x, group, seq_dim)
    return C.gather_summed(C.copy_to(x, group), seq_dim, group)


FAULT_ENTRY = []


def _grads(cfg, mesh, tree: dict, batch: dict) -> tuple:
    """(loss, the rank's gradient blocks) of ``build_sharded_grads``."""
    from repro_torch.launch.steps import build_sharded_grads
    from repro_torch.models import registry as R
    from repro_torch.sharding import spmd
    from repro_torch.tree import tree_map
    params = convert.model_params_from_numpy(cfg, tree, device="cpu")
    shardings = TP.logical_to_sharding(
        TP.param_specs(R.param_specs(cfg), cfg, mesh), mesh)
    loss, grads = build_sharded_grads(cfg, mesh)(
        spmd.shard_tree(params, shardings),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), tree_map(lambda g: g.to_local(), grads)


def _run_case(cfg, shape: tuple, tree: dict, inputs: dict) -> dict:
    """One rank's prefill, decode steps and training step of ``cfg``, and
    the rows its layers saw (``RowHook``)."""
    from repro_torch.launch import steps as S_
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry as R
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    b, s = inputs["prompt"]["tokens"].shape
    if "patch_embeds" in inputs["prompt"]:
        s += inputs["prompt"]["patch_embeds"].shape[1]
    mesh = make_mesh(shape, AXES, device_type="cpu")
    coord = tuple(mesh.get_coordinate())
    model = R.build_model(cfg)
    params = convert.model_params_from_numpy(cfg, tree, device="cpu")
    as_t = {k: torch.from_numpy(v) for k, v in inputs["prompt"].items()}
    prefill = S_.build_prefill_step(cfg, ShapeCell("sp", s, b, "prefill"),
                                    mesh=mesh, device="cpu")
    serve = S_.build_serve_step(cfg, ShapeCell("sp", s, b, "decode"),
                                mesh=mesh, device="cpu")
    whole_cache = model.init_cache(b, s + R.DECODE_SLACK, device="cpu")
    cspecs = TP.cache_specs(whole_cache, cfg, mesh)
    cache = _blocks(whole_cache, cspecs, mesh, coord)
    lp = _blocks(params, prefill.in_shardings[0], mesh, coord)
    out = {"coord": coord}
    with torch.no_grad(), RowHook() as hook:
        logits, cache = prefill.fn(
            lp, _blocks(as_t, TP.batch_specs(as_t, cfg, mesh), mesh, coord),
            cache)
    out["prefill_rows"] = hook.rows
    out["prefill"] = logits
    out["prefill_cache"] = [x.clone() for x, _ in _cache_pairs(cache, cspecs)]
    out["decode"] = []
    with torch.no_grad():
        for tok in inputs["tokens"]:
            logits, cache = serve.fn(
                lp, _blocks(torch.from_numpy(tok), serve.in_shardings[1],
                            mesh, coord), cache)
            out["decode"].append(logits)
    out["cache"] = [x for x, _ in _cache_pairs(cache, cspecs)]
    opt = AdamWConfig(warmup_steps=0)
    train = S_.build_train_bundle(cfg, ShapeCell("sp", s, b, "train"),
                                  mesh=mesh, device="cpu", opt=opt)
    state = init_opt_state(params, device="cpu")
    lo = {"m": _blocks(state["m"], train.in_shardings[1]["m"], mesh, coord),
          "v": _blocks(state["v"], train.in_shardings[1]["v"], mesh, coord),
          "count": state["count"]}
    tb = {k: torch.from_numpy(v) for k, v in inputs["train"].items()}
    with RowHook() as hook:
        new, _, metrics = train.fn(
            _blocks(params, train.in_shardings[0], mesh, coord), lo,
            _blocks(tb, TP.batch_specs(tb, cfg, mesh), mesh, coord))
    out["train_rows"] = hook.rows
    out["loss"], out["params"] = float(metrics["loss"]), new
    return out


def _refusal(cfg, shape: tuple, b: int, s: int) -> dict:
    """The error texts of the train and prefill builders on the rank's
    ``DeviceMesh`` (``None`` where one builds)."""
    from repro_torch.launch import steps as S_
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, AXES, device_type="cpu")
    out = {}
    for kind, build in (("train", S_.build_train_bundle),
                        ("prefill", S_.build_prefill_step)):
        try:
            build(cfg, ShapeCell("sp", s, b, kind), mesh=mesh, device="cpu")
            out[kind] = None
        except ValueError as e:
            out[kind] = str(e)
    return out


def _rank_main(rank: int, root: str) -> None:
    from repro_torch.models import layers as L
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"), WORLD),
        rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=120))

    def save(obj, tag):
        torch.save(obj, os.path.join(root, f"{tag}-{rank}.pt"))
    try:
        data = torch.load(os.path.join(root, "data.pt"), weights_only=False)
        for name, (_, _, meshes, b, s) in CONFIGS.items():
            for label in meshes:
                save(_run_case(_port_cfg(name), MESHES[label], *data[name]),
                     f"{name}-{label}")
        save(_refusal(_port_cfg("qwen3-zero3"), MESHES["2x2"],
                      ZERO3_TAKES_MODEL, 24), "zero3-refusal")
        tree, inputs = data["rwkv6"]
        for hint in (False, True):
            cfg = dataclasses.replace(get_config("rwkv6-1.6b").reduced(),
                                      sequence_parallel=hint)
            save(_run_case(cfg, MESHES["1x4"], tree, inputs),
                 f"rwkv6-{hint}")
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(MESHES["1x4"], AXES, device_type="cpu")
        tree, inputs = data["qwen3"]
        save(_grads(_port_cfg("qwen3"), mesh, tree, inputs["train"]),
             "grads")
        FAULT_ENTRY.append(L._ffn_entry)
        L._ffn_entry = _copy_then_gather
        try:
            save(_grads(_port_cfg("qwen3"), mesh, tree, inputs["train"]),
                 "fault")
        finally:
            L._ffn_entry = FAULT_ENTRY.pop()
    finally:
        dist.destroy_process_group()


def _jax_reference(jax, jnp, JR, adamw, cfg, tree: dict, inputs: dict
                   ) -> dict:
    """The JAX package's unsharded run of one case from its NumPy weights
    and inputs: prefill, decode steps, the loss and its gradients, and
    one AdamW step."""
    model = JR.build_model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    prompt = {k: jnp.asarray(v) for k, v in inputs["prompt"].items()}
    b, s = inputs["prompt"]["tokens"].shape
    if "patch_embeds" in inputs["prompt"]:
        s += inputs["prompt"]["patch_embeds"].shape[1]
    cache = model.init_cache(b, s + JR.DECODE_SLACK)

    def leaves(c) -> list:      # the cache's tensors, its length left out
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(c)
                if np.ndim(x)]

    logits, cache = jax.jit(model.prefill)(params, prompt, cache)
    want = {"prefill": np.asarray(logits), "prefill_cache": leaves(cache),
            "decode": []}
    decode = jax.jit(model.decode_step)
    for tok in inputs["tokens"]:
        logits, cache = decode(params, jnp.asarray(tok), cache)
        want["decode"].append(np.asarray(logits))
    want["cache"] = leaves(cache)
    train = {k: jnp.asarray(v) for k, v in inputs["train"].items()}
    loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(params, train)
    new, _ = adamw.adamw_update(adamw.AdamWConfig(warmup_steps=0), params,
                                grads, adamw.init_opt_state(params))
    want["loss"] = float(loss)
    want["grads"] = jax.tree_util.tree_map(np.asarray, grads)
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
    from repro_torch.models import registry as R
    from repro_torch.tree import tree_map
    root = str(tmp_path_factory.mktemp("sp"))
    data, jcfgs = {}, {}
    for name in CONFIGS:
        arch, changes = CONFIGS[name][:2]
        jcfgs[name] = dataclasses.replace(jget(arch).reduced(), **changes)
        g = torch.Generator()
        g.manual_seed(_seed(name))
        params = R.build_model(_port_cfg(name)).init_params(g, device="cpu")
        data[name] = (tree_map(lambda t: t.numpy(), params), _inputs(name))
    g = torch.Generator()
    g.manual_seed(7)
    rcfg = get_config("rwkv6-1.6b").reduced()
    params = R.build_model(rcfg).init_params(g, device="cpu")
    rng = np.random.default_rng(7)
    data["rwkv6"] = (tree_map(lambda t: t.numpy(), params), {
        "prompt": {"tokens": rng.integers(0, 512, (4, 24), dtype=np.int32)},
        "train": {"tokens": rng.integers(0, 512, (4, 24), dtype=np.int32),
                  "labels": rng.integers(0, 512, (4, 24), dtype=np.int32)},
        "tokens": [rng.integers(0, 512, (4, 1), dtype=np.int32)
                   for _ in range(STEPS)]})
    torch.save(data, os.path.join(root, "data.pt"))
    ctx = mp.start_processes(_rank_main, args=(root,), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=TIMEOUT_S)
    try:
        with ThreadPoolExecutor(JAX_THREADS) as pool:
            refs = {name: pool.submit(_jax_reference, jax, jnp, JR, adamw,
                                      jcfgs[name], *data[name])
                    for name in CONFIGS}
            wants = {name: f.result() for name, f in refs.items()}
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
    """(param specs, the cache's leaf specs in JAX's leaf order, logits
    spec) of case ``name`` on ``shape``."""
    from repro_torch.models import registry as R
    cfg, (*_, b, s) = _port_cfg(name), CONFIGS[name]
    mesh = TP.AbstractMesh(shape, AXES)
    pspecs = TP.param_specs(R.param_specs(cfg), cfg, mesh)
    cache = R.build_model(cfg).init_cache(b, s + R.DECODE_SLACK,
                                          device="meta")
    cspecs = [sp for _, sp in _cache_pairs(cache, TP.cache_specs(
        cache, cfg, mesh))]
    return pspecs, cspecs, TP.logits_spec((b, 1, cfg.padded_vocab), cfg,
                                          mesh)


CASES = [(n, m) for n, c in CONFIGS.items() for m in c[2]]
IDS = [f"{n}-{m}" for n, m in CASES]


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_prefill_and_decode_match_jax(runs, name, mesh):
    wants, load = runs
    want = wants[name]
    shape = MESHES[mesh]
    _, cspecs, lspec = _specs(name, shape)
    for rank in range(WORLD):
        got = load(f"{name}-{mesh}", rank)
        coord = got["coord"]
        _close(got["prefill"], _block_of(want["prefill"][:, -1:], lspec,
                                         shape, coord))
        for key in ("prefill_cache", "cache"):
            for g, w, sp in zip(got[key], want[key], cspecs, strict=True):
                _close(g, _block_of(w, sp, shape, coord))
        for g, w in zip(got["decode"], want["decode"], strict=True):
            _close(g, _block_of(w, lspec, shape, coord))


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_train_step_matches_jax(runs, name, mesh):
    from repro_torch.tree import tree_items
    wants, load = runs
    want = wants[name]
    shape = MESHES[mesh]
    pspecs, _, _ = _specs(name, shape)
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


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_residual_stream_holds_the_ranks_rows(runs, name, mesh):
    """Every layer takes and returns S/m rows of the residual stream, in
    the prefill and in the training step (the whole S where S does not
    divide m: ``qwen3-s22``)."""
    _, load = runs
    cfg = _port_cfg(name)
    m = MESHES[mesh][1]
    s = CONFIGS[name][4]
    rows = s // m if s % m == 0 else s
    for rank in range(WORLD):
        got = load(f"{name}-{mesh}", rank)
        # prefill: each layer's attention and FFN; training: each block,
        # under remat="full" once more in the backward's recomputation
        assert got["prefill_rows"] == [(rows, rows)] * (
            2 * cfg.num_layers), got["prefill_rows"]
        assert set(got["train_rows"]) == {(rows, rows)}
        assert len(got["train_rows"]) >= cfg.num_layers


def test_zero3_batch_on_the_model_axis_raises(runs):
    """``zero3`` at a batch that splits over data and model: the train and
    prefill builders raise ``ValueError`` on the rank's ``DeviceMesh``,
    and on an ``AbstractMesh`` too; at B = 2 they build (the case
    ``qwen3-zero3`` runs)."""
    from repro_torch.launch import steps as S_
    _, load = runs
    for rank in range(WORLD):
        got = load("zero3-refusal", rank)
        assert set(got) == {"train", "prefill"}
        assert all("DuplicateSpecError" in text for text in got.values())
    cfg = _port_cfg("qwen3-zero3")
    mesh = TP.AbstractMesh(MESHES["2x2"], AXES)
    for kind, build in (("train", S_.build_train_bundle),
                        ("prefill", S_.build_prefill_step)):
        with pytest.raises(ValueError, match="DuplicateSpecError"):
            build(cfg, ShapeCell("sp", 24, ZERO3_TAKES_MODEL, kind),
                  mesh=mesh, device="meta")
        build(cfg, ShapeCell("sp", 24, 2, kind), mesh=mesh, device="meta")
    assert TP.sequence_axis(cfg, mesh, 2, 24) == "model"
    assert TP.sequence_axis(cfg, mesh, 2, 23) is None
    plain = _port_cfg("qwen3")          # not zero3: the batch never takes it
    assert TP.sequence_axis(plain, mesh, 4, 24) == "model"
    assert TP.sequence_axis(dataclasses.replace(
        plain, sequence_parallel=False), mesh, 4, 24) is None


def test_rwkv6_ignores_the_hint(runs):
    """rwkv6 with the hint on is bitwise its run with the hint off: every
    logits block, cache leaf, loss and updated parameter."""
    from repro_torch.tree import tree_leaves
    _, load = runs
    for rank in range(WORLD):
        off, on = load("rwkv6-False", rank), load("rwkv6-True", rank)
        assert on["loss"] == off["loss"]
        pairs = [(on["prefill"], off["prefill"])]
        pairs += list(zip(on["decode"], off["decode"], strict=True))
        for key in ("prefill_cache", "cache"):
            pairs += list(zip(on[key], off[key], strict=True))
        pairs += list(zip(tree_leaves(on["params"]),
                          tree_leaves(off["params"]), strict=True))
        assert all(torch.equal(a, b) for a, b in pairs)


def _grads_close(got, want: dict, shape: tuple) -> None:
    from repro_torch.tree import tree_items
    pspecs, _, _ = _specs("qwen3", shape)
    specs = dict(tree_items(pspecs))
    wanted = dict(tree_items(want))
    for key, g in tree_items(got[1]):
        _close(g, _block_of(wanted[key], specs[key], shape, got[0]))


def test_a_gradient_counted_m_times_fails(runs):
    """qwen3's gradients on ``(1, 4)`` match JAX's; with ``copy_to`` kept
    in front of the FFN entry's ``gather_summed`` on every rank they do
    not (the FFN input's gradient counted four times)."""
    wants, load = runs
    shape = MESHES["1x4"]
    want = wants["qwen3"]["grads"]
    for rank in range(WORLD):
        coord = load("qwen3-1x4", rank)["coord"]
        loss, grads = load("grads", rank)
        assert abs(loss - wants["qwen3"]["loss"]) <= TOL
        _grads_close((coord, grads), want, shape)
        loss, grads = load("fault", rank)
        assert abs(loss - wants["qwen3"]["loss"]) <= TOL   # forward intact
        with pytest.raises(AssertionError):
            _grads_close((coord, grads), want, shape)


def test_gloo_stages_only_card_tensors(monkeypatch):
    """The plain collectives carry a host copy only for a CUDA tensor in a
    gloo group (two ranks on one card): a CPU or meta tensor in a gloo
    group, and any tensor in an NCCL group, go to the functional op as
    they are.  No card here: the backend query is patched and the CUDA
    tensor is a stand-in with its device."""
    import types
    from repro_torch.sharding import collectives as C
    backend = {"name": "gloo"}
    monkeypatch.setattr(C, "_backend", lambda group: backend["name"])
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    cpu, meta = torch.ones(3), torch.empty(3, device="meta")
    assert C.host_staged(card, object())
    assert not C.host_staged(cpu, object())
    assert not C.host_staged(meta, object())
    seen = []
    out = C._run(cpu, object(), lambda t: seen.append(t) or t * 2)
    assert seen[0] is cpu and torch.equal(out, cpu * 2)
    backend["name"] = "nccl"
    assert not C.host_staged(card, object())

