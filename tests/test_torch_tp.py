"""Tensor-parallel compute of every model family over four gloo ranks,
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
embeddings before 8 text tokens, M-RoPE); ``rwkv6-1.6b`` (4 wkv heads, one
a rank at model axis 4; ``mix_down``'s 20 columns split 5 a rank across
the five mixes' groups of 4, as the published 160 split 10 a rank across
groups of 32; ``u``, ``w0``, ``mix_base`` and ``ln_x`` redrawn, the JAX
init leaving them constant); ``seamless-m4t-large-v2`` (24 stub frames
and 3 decoder tokens a prompt, its cross cache's 24 rows and self cache's
40 split over the model axis); ``zamba2-7b`` (8 SSD heads of 16: at model
axis 4 ``in_proj``'s 296 columns split 74 a rank against a rank's 32
``z`` and 32 ``x`` columns, as the published 14576 split 911 a rank
against 448; the LoRA ``*b`` stacks, ``conv_b``, ``dt_bias``, ``D`` and
``norm_scale`` redrawn).

Each config's weights come from the port's ``init_params`` (the JAX
tree's names and layouts) drawn from a seeded generator, as NumPy: the
JAX functions take them as they are and each rank through
``convert.model_params_from_numpy``; the inputs are drawn with NumPy
from a seed.  Each rank runs the steps ``launch/steps.py`` builds on
its ``DeviceMesh`` over its blocks: a prefill of 4 prompts of 24 positions
into a cache of 40 rows (its sequence axis on the model axis: 10 or 20
rows a rank, so at model axis 4 the last rank holds no valid row during
the decode steps; rwkv6's and zamba2's states on it by head and channel),
3 decode steps, and one training step (AdamW at ``warmup_steps=0``, so
the step moves every parameter).  Held against the JAX package's
unsharded functions (``repro.sharding.api.deactivate()`` first) on the
rank's blocks: the prefill logits (the rank's rows and vocabulary
columns) and every cache leaf it wrote, every decode step's logits and
the cache after them, the training loss and every updated parameter
block -- all in float32 within rtol/atol ``TOL`` = 2e-4, the transformer
tests' bound.  Also: each rank's weights hold ``1/m`` of every split
weight's model dimension (the bundle's local shapes);
``build_sharded_grads`` never calls ``spmd.full_tree``; and planted
faults must move the logits past ``TOL``: rank 1 keeping its own partial
``wo`` product in place of the all-reduced sum (qwen3), and rank 1
keeping its own partial moments of a norm over a split axis (rwkv6's
``ln_x``, zamba2's gated RMS norm).
"""

import dataclasses
import datetime
import logging
import os
import types
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
B, S, S_MAX, STEPS = 4, 24, 40, 3
CONFIGS = {
    "qwen3": ("qwen3-1.7b", {}),
    "heads6x3": ("phi3-medium-14b", {"num_heads": 6, "num_kv_heads": 3}),
    "heads6x3-sp": ("phi3-medium-14b", {"num_heads": 6, "num_kv_heads": 3,
                                        "sequence_parallel": True}),
    "moonshot-ep": ("moonshot-v1-16b-a3b", {"moe_parallel": "ep"}),
    "moonshot-tp": ("moonshot-v1-16b-a3b", {"moe_parallel": "tp"}),
    "qwen2-vl": ("qwen2-vl-72b", {}),
    "rwkv6": ("rwkv6-1.6b", {}),
    "seamless": ("seamless-m4t-large-v2", {}),
    "zamba2": ("zamba2-7b", {}),
}
# the planted faults: case -> the shared piece rank 1 breaks
FAULTS = {"qwen3": "wo", "rwkv6": "ln_x", "zamba2": "gated_norm"}
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
AXES = ("data", "model")
TIMEOUT_S = 300
JAX_THREADS = 3


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
    vlm, audio = cfg.family == "vlm", cfg.family == "audio"

    def embeds(n: int) -> np.ndarray:
        return (0.02 * rng.standard_normal((B, n, cfg.d_model))).astype(
            np.float32)

    def batch(train: bool) -> dict:
        # the audio family: frames and decoder tokens as ``make_batch``
        # splits a serving and a training batch
        text = S - cfg.frontend_tokens if vlm else S
        if audio:
            text = S - S // 2 if train else S // 8
        out = {"tokens": rng.integers(0, cfg.vocab_size, (B, text),
                                      dtype=np.int32)}
        if vlm:
            out["patch_embeds"] = embeds(cfg.frontend_tokens)
        if audio:
            out["embeds"] = embeds(S // 2 if train else S)
        if train:
            out["labels"] = rng.integers(0, cfg.vocab_size, (B, text),
                                         dtype=np.int32)
        return out
    return {"prompt": batch(False), "train": batch(True),
            "tokens": [rng.integers(0, cfg.vocab_size, (B, 1),
                                    dtype=np.int32) for _ in range(STEPS)]}


# leaves the JAX init leaves constant (zero LoRA ``*b``, ``u``, a constant
# ``w0``, unit norm scales), redrawn so a rank's cut of them shows
_REDRAWN = {"rwkv6": ("layers/u", "layers/w0", "layers/mix_base",
                      "layers/ln_x/scale", "layers/ln_x/bias"),
            "zamba2": ("lora/qb", "lora/kb", "lora/vb", "mamba/conv_b",
                       "mamba/dt_bias", "mamba/D", "mamba/norm_scale")}


def _redraw(name: str, tree: dict) -> dict:
    rng = np.random.default_rng(100 + _seed(name))
    for path in _REDRAWN.get(name, ()):
        *keys, last = path.split("/")
        node = tree
        for k in keys:
            node = node[k]
        a = node[last]
        node[last] = (0.3 * rng.standard_normal(a.shape) + (
            -3.0 if last == "w0" else 0.0)).astype(a.dtype)
    return tree


def _cache_kw(cfg) -> dict:
    """The audio family's cache holds the prompt's frames."""
    return {"enc_len": S} if cfg.family == "audio" else {}


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


def _partial_moments(x, group):
    """``layers.group_sum`` that takes part in the all-reduce but keeps
    the rank's own partial sum."""
    from repro_torch.models import layers as L
    return (L.collectives.reduce_from(x, group), x)[1]


def _planted(kind: str):
    """Break ``kind`` on this rank: (module, attribute, the broken
    function)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    if kind == "wo":
        return T, "_attention_tp", _faulty_wo(T._attention_tp)
    return L, "group_sum", _partial_moments


def _run_case(name: str, shape: tuple, tree: dict, inputs: dict, *,
              fault: "str | None" = None) -> dict:
    """One rank's prefill, decode steps and training step of one case
    (with ``fault``, the prefill alone, ``fault`` planted on rank 1)."""
    from repro_torch.launch import steps as S_
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry as R
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.tree import tree_items
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
    whole_cache = model.init_cache(B, S_MAX, device="cpu", **_cache_kw(cfg))
    cspecs = TP.cache_specs(whole_cache, cfg, mesh)
    cache = _blocks(whole_cache, cspecs, mesh, coord)
    lp = _blocks(params, prefill.in_shardings[0], mesh, coord)
    out = {"coord": coord,
           "shapes": {k: tuple(x.shape)
                      for k, x in tree_items(prefill.arg_specs[0])}}
    patch = None
    if fault and dist.get_rank() == 1:
        module, attr, broken = _planted(fault)
        patch = (module, attr, getattr(module, attr))
        setattr(module, attr, broken)
    try:
        with torch.no_grad():
            logits, cache = prefill.fn(
                lp, _blocks(as_t, prefill.in_shardings[1], mesh, coord),
                cache)
            out["prefill"] = logits
            out["prefill_cache"] = [x.clone() for x, _ in
                                    _cache_pairs(cache, cspecs)]
            if fault:
                return out
            out["decode"] = []
            for tok in inputs["tokens"]:
                logits, cache = serve.fn(
                    lp, _blocks(torch.from_numpy(tok),
                                serve.in_shardings[1], mesh, coord), cache)
                out["decode"].append(logits)
            out["cache"] = [x for x, _ in _cache_pairs(cache, cspecs)]
    finally:
        if patch is not None:
            setattr(*patch)
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


NO_FULL_TREE = ("qwen3", "rwkv6", "seamless", "zamba2")


def _grads_without_full_tree(root: str, name: str) -> None:
    """``build_sharded_grads`` of a reduced case on ``(2, 2)`` with
    ``spmd.full_tree`` made to raise."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_sharded_grads
    from repro_torch.models import registry as R
    from repro_torch.sharding import spmd
    cfg = _port_cfg(name)
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
    torch.save(float(loss), os.path.join(
        root, f"nofull-{name}-{dist.get_rank()}.pt"))


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
        for name, kind in FAULTS.items():
            torch.save(_run_case(name, MESHES["1x4"], *data[name],
                                 fault=kind),
                       os.path.join(root, f"fault-{kind}-{rank}.pt"))
        for name in NO_FULL_TREE:
            _grads_without_full_tree(root, name)
    finally:
        dist.destroy_process_group()


def _jax_reference(jax, jnp, JR, adamw, cfg, tree: dict, inputs: dict
                   ) -> dict:
    """The JAX package's unsharded run of one case from its NumPy weights
    and inputs: prefill, decode steps and one training step."""
    model = JR.build_model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    prompt = {k: jnp.asarray(v) for k, v in inputs["prompt"].items()}
    cache = model.init_cache(B, S_MAX, **_cache_kw(cfg))

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
    root = str(tmp_path_factory.mktemp("tp"))
    cfgs, data, by_seed = {}, {}, {}
    for name in CONFIGS:
        cfgs[name] = dataclasses.replace(jget(CONFIGS[name][0]).reduced(),
                                         **CONFIGS[name][1])
        g = torch.Generator()
        g.manual_seed(_seed(name))
        params = R.build_model(_port_cfg(name)).init_params(g, device="cpu")
        data[name] = (_redraw(name, tree_map(lambda t: t.numpy(), params)),
                      _inputs(name))
        by_seed.setdefault(_seed(name), name)
    torch.save(data, os.path.join(root, "data.pt"))
    ctx = mp.start_processes(_rank_main, args=(root,), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=TIMEOUT_S)
    try:
        # one reference an arch, traced and compiled on threads beside
        # the ranks (XLA compiles outside the interpreter lock)
        with ThreadPoolExecutor(JAX_THREADS) as pool:
            refs = {seed: pool.submit(_jax_reference, jax, jnp, JR, adamw,
                                      cfgs[name], *data[name])
                    for seed, name in by_seed.items()}
            wants = {name: refs[_seed(name)].result() for name in CONFIGS}
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
    """(config, param specs, the cache's leaf specs in JAX's leaf order,
    logits spec) of a case on ``shape``."""
    cfg = _port_cfg(name)
    mesh = TP.AbstractMesh(shape, AXES)
    from repro_torch.models import registry as R
    pspecs = TP.param_specs(R.param_specs(cfg), cfg, mesh)
    cache = R.build_model(cfg).init_cache(B, S_MAX, device="meta",
                                          **_cache_kw(cfg))
    cspecs = [sp for _, sp in _cache_pairs(cache, TP.cache_specs(
        cache, cfg, mesh))]
    return (cfg, pspecs, cspecs,
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


def _shares(cfg, dp: int, m: int) -> dict:
    """Each rank's local shape of a case's split weights on ``(dp, m)``:
    ``1/m`` of the dimension the model axis splits (heads, FFN columns,
    vocabulary rows of the layers' products), ``1/dp`` of the one FSDP
    splits (``d_model``) -- written from the configs, not from the
    specs."""
    n, d, hd, f = cfg.num_layers, cfg.d_model, cfg.head_dim, cfg.d_ff
    qh, kh = cfg.num_heads * hd, cfg.num_kv_heads * hd
    if cfg.family == "ssm":
        hk, rm, rd = qh, 5 * cfg.rwkv_mix_lora, cfg.rwkv_decay_lora
        out = {f"layers/{w}": (n, d // dp, hk // m)
               for w in ("wr", "wk", "wv", "wg")}
        out.update({"layers/wo": (n, hk // m, d // dp),
                    "layers/cm_wk": (n, d // dp, f // m),
                    "layers/cm_wv": (n, f // m, d // dp),
                    "layers/cm_wr": (n, d // dp, d // m),
                    "layers/mix_down": (n, d // dp, rm // m),
                    "layers/w_down": (n, d // m, rd // dp),
                    "layers/w_up": (n, rd // dp, hk // m)})
        return out
    if cfg.family == "hybrid":
        di, ns = d * cfg.ssm_expand, cfg.ssm_state
        heads = di // cfg.ssm_headdim
        inv, r = cfg.num_layers // cfg.shared_attn_period, cfg.lora_rank
        return {"mamba/in_proj": (n, d // dp, (2 * di + 2 * ns + heads) // m),
                "mamba/conv_w": (n, cfg.ssm_conv, (di + 2 * ns) // m),
                "mamba/out_proj": (n, di // m, d // dp),
                "shared/in_proj": (2 * d // dp, d // m),
                "shared/wq": (d // dp, qh // m),
                "shared/wk": (d // dp, kh // m),
                "shared/wo": (qh // m, d // dp),
                "shared/w_up": (d // dp, f // m),
                "shared/w_down": (f // m, d // dp),
                "lora/qb": (inv, r, qh // m), "lora/kb": (inv, r, kh // m)}
    if cfg.family == "audio":
        out = {}
        for stack, attn in (("encoder", "attn"), ("decoder", "self_attn"),
                            ("decoder", "cross_attn")):
            nl = n if stack == "encoder" else cfg.num_decoder_layers
            out.update({f"{stack}/{attn}/wq": (nl, d // dp, qh // m),
                        f"{stack}/{attn}/wk": (nl, d // dp, kh // m),
                        f"{stack}/{attn}/wv": (nl, d // dp, kh // m),
                        f"{stack}/{attn}/wo": (nl, qh // m, d // dp),
                        f"{stack}/w_up": (nl, d // dp, f // m),
                        f"{stack}/w_down": (nl, f // m, d // dp)})
        return out
    ma = 1 if cfg.sequence_parallel and cfg.num_heads % m else m
    return {"layers/wq": (n, d // dp, qh // ma),
            "layers/wk": (n, d // dp, kh // ma),
            "layers/wv": (n, d // dp, kh // ma),
            "layers/wo": (n, qh // ma, d // dp)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_weights_hold_their_model_axis_share(runs, mesh):
    """Each rank's split weights hold ``1/m`` of their model dimension and
    ``1/dp`` of ``d_model`` (``_shares``): the attention families' ``wq``
    / ``wk`` / ``wv`` their output columns and ``wo`` its input rows --
    whole under the ``sequence_parallel`` hint where the heads do not
    divide the model axis --, and every split weight of rwkv6, zamba2
    and enc-dec."""
    _, load = runs
    dp, m = MESHES[mesh]
    for name in CONFIGS:
        want = _shares(_port_cfg(name), dp, m)
        for rank in range(WORLD):
            shapes = load(f"{name}-{mesh}", rank)["shapes"]
            assert {k: shapes[k] for k in want} == want, name


def test_sharded_grads_take_no_full_tree(runs):
    """``build_sharded_grads`` runs without ``spmd.full_tree`` for the
    attention families (qwen3) and for rwkv6, enc-dec and zamba2."""
    _, load = runs
    for name in NO_FULL_TREE:
        losses = [load(f"nofull-{name}", rank) for rank in range(WORLD)]
        assert all(np.isfinite(losses)) and len(set(losses)) == 1, name


def _fault_read(wants, load, name: str, kind: str) -> None:
    """Rank 1's prefill logits with ``kind`` planted fail the check that
    ``test_prefill_and_decode_match_jax`` makes, by more than 10 ``TOL``."""
    shape = MESHES["1x4"]
    _, _, _, lspec = _specs(name, shape)
    got = load(f"fault-{kind}", 1)
    block = _block_of(wants[name]["prefill"][:, -1:], lspec, shape,
                      got["coord"])
    with pytest.raises(AssertionError):
        _close(got["prefill"], block)
    assert float(np.abs(got["prefill"].numpy() - block).max()) > 10 * TOL


def test_a_rank_that_keeps_its_partial_wo_product_fails(runs):
    """Rank 1 keeping its own ``wo`` partial sum fails the prefill check
    that ``test_prefill_and_decode_match_jax`` makes."""
    _fault_read(*runs, "qwen3", "wo")


@pytest.mark.parametrize("name", ["rwkv6", "zamba2"])
def test_a_rank_that_keeps_its_partial_norm_moments_fails(runs, name):
    """Rank 1 skipping the all-reduce of a norm's moments over a split
    axis -- rwkv6's ``ln_x`` over the wkv heads' channels, zamba2's gated
    RMS norm over ``d_inner`` -- and normalising by its own fails the
    prefill check."""
    _fault_read(*runs, name, FAULTS[name])
