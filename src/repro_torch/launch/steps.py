"""Step functions, as the JAX package's ``launch/steps.py`` builds them.

  train_step(params, opt_state, batch)   -> (params, opt_state, metrics)
  prefill_step(params, batch, cache)     -> (logits, cache)
  serve_step(params, tokens, cache)      -> (logits, cache)

``build_train_step(cfg, opt, grad_compress)`` returns the first:

loss -> gradients (summed in float32 over microbatches) -> the optional
gradient hook (the approximate collective's quantize round trip,
``core.approx_comm.make_grad_compressor``) -> AdamW.  The microbatch
count follows the JAX adaptive rule: ``cfg.train_microbatches``, lowered
until every microbatch splits evenly over the data-parallel members (the
DP size of ``mesh``, 1 without one).  The first half is also exposed
(``compute_grads``), so a caller can run the hook and
``optim.adamw.adamw_update`` on gradients it already has, as the step
and the sharded step of ``launch/train.py`` do.  AdamW writes the new
parameters and moments into the tensors it is given, where the JAX step
donates them.

``build_train_bundle`` / ``build_prefill_step`` / ``build_serve_step(cfg,
cell)`` return a ``StepBundle``: the step function of one shape cell, meta
stand-ins of its arguments (``arg_specs``, the counterpart of the JAX
bundle's ``arg_structs``), the arguments the step writes in place
(``donate_argnums``: the cache, where the JAX step donates it) and, with a
``mesh`` (a ``DeviceMesh`` or an ``AbstractMesh``), the spec trees of its
arguments and outputs (``in_shardings`` / ``out_shardings``, JAX's
bundles' specs; ``None`` without one).  A serve cell's cache stands at
``length = seq_len``: one decode step at that context.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ATTENTION_IMPLS, ModelConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.meta import loop_repeats, repeated
from repro_torch.models.registry import (Model, build_model, cache_spec,
                                         input_specs, param_specs)
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                    init_opt_state)
from repro_torch.sharding import partition
from repro_torch.sharding.partition import PartitionSpec as P
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["build_train_step", "build_train_bundle",
           "build_sharded_grads", "build_sharded_train_step",
           "build_prefill_step",
           "build_serve_step", "StepBundle", "microbatch_count",
           "compute_grads"]

STEP_DEVICES = ("cuda", "cpu", "meta")


@dataclasses.dataclass
class StepBundle:
    """One (arch, cell) step: ``fn``, meta stand-ins of its arguments
    (``arg_specs``: shapes and dtypes, no storage), the arguments it writes
    in place (``donate_argnums``), the device its real arguments live on
    (``device``) and, when built on a mesh, the ``PartitionSpec`` trees of
    its arguments and outputs."""
    fn: Callable
    arg_specs: tuple
    donate_argnums: tuple
    device: torch.device
    in_shardings: Any = None
    out_shardings: Any = None


def microbatch_count(cfg: ModelConfig, global_batch: int,
                     dp_size: int = 1) -> int:
    """The JAX step's microbatch rule: ``cfg.train_microbatches`` (at
    least 1), lowered until every microbatch has a whole share of the batch
    for each of ``dp_size`` data-parallel members."""
    m = max(1, cfg.train_microbatches)
    while m > 1 and (global_batch % m != 0
                     or (global_batch // m) % dp_size != 0):
        m -= 1
    return m


def _value_and_grad(model: Model, params: dict, batch: dict
                    ) -> tuple[torch.Tensor, dict]:
    """The loss and its gradient with respect to every parameter leaf (the
    parameters themselves are left without ``requires_grad``)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = model.loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    # tree_leaves and tree_map both walk the keys in sorted order
    return loss.detach(), _fill(leaves, it)


def _fill(tree, it):
    if not isinstance(tree, dict):
        return next(it)
    return {k: _fill(tree[k], it) for k in sorted(tree)}


def compute_grads(model: Model, params: dict, batch: dict,
                  microbatches: int) -> tuple[torch.Tensor, dict]:
    """(loss, gradients) of one step.  One microbatch: the loss and the
    gradients in the parameters' dtype.  More: the batch is split into
    ``microbatches`` equal consecutive row blocks (the JAX reshape), the
    losses and float32 gradients summed over them in order, both divided
    by the count."""
    if microbatches == 1:
        return _value_and_grad(model, params, batch)
    b = batch["tokens"].shape[0] // microbatches
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    # on the meta device the first microbatch stands for all of them
    reps = loop_repeats(microbatches, batch["tokens"], alike=True)
    for i, n in enumerate(reps):
        if not n:
            continue
        mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        with repeated(n):
            loss, grads = _value_and_grad(model, params, mb)
            tree_map(lambda a, g: a.add_(g), acc, grads)
            loss_sum = loss_sum + loss
        del loss, grads         # no iteration keeps its predecessor's
    tree_map(lambda a: a.div_(microbatches), acc)
    return loss_sum / microbatches, acc


def build_train_step(cfg: ModelConfig, opt: AdamWConfig | None = None,
                     grad_compress: Callable | None = None, *,
                     mesh=None) -> Callable:
    """The full training step of ``cfg``'s model: loss -> gradients ->
    ``grad_compress`` (the approximate collective's hook, optional) ->
    AdamW (``opt``, default ``AdamWConfig()``).  The step returns
    ``(params, opt_state, {"loss": float32 0-d tensor})``.  With ``mesh``
    the microbatch count keeps every microbatch whole over the mesh's DP
    size (``("pod", "data")``, all axes under ``zero3``), as JAX's does;
    the batch it is given is the global one."""
    model = build_model(cfg)
    opt = opt or AdamWConfig()
    dp = 1 if mesh is None else partition.dp_size(mesh, cfg)

    def train_step(params: dict, opt_state: dict, batch: dict
                   ) -> tuple[dict, dict, dict[str, Any]]:
        m = microbatch_count(cfg, batch["tokens"].shape[0], dp)
        loss, grads = compute_grads(model, params, batch, m)
        if grad_compress is not None:
            # rebinding drops the uncompressed gradients before AdamW's
            # float32 temporaries (no second copy of every gradient at the
            # update's peak)
            grads = grad_compress(grads)
        params, opt_state = adamw_update(opt, params, grads, opt_state)
        return params, opt_state, {"loss": loss.float()}

    return train_step


def build_sharded_grads(cfg: ModelConfig, mesh,
                        grad_compress: Callable | None = None
                        ) -> Callable:
    """The first half of ``build_sharded_train_step``:
    ``grads(params, batch) -> (loss, grads)`` of one rank of ``mesh`` (a
    ``DeviceMesh`` over an initialised process group), with ``params`` a
    tree of ``DTensor``s stored per ``param_specs`` and ``batch`` the
    global batch (every rank passes the same one).

    It gathers the whole parameters, takes the rank's rows of the batch
    per ``batch_specs`` (over the DP axes, so the model-axis ranks of one
    DP group share rows; over every axis under ``zero3``), computes the
    loss and gradients with ``compute_grads`` (the microbatch count at
    the mesh's DP size), averages both over the rank's DP group
    (``all_reduce``, then a division by its size) and applies
    ``grad_compress`` to the mean gradients (after the reduction, as JAX
    applies it after GSPMD's).  Every rank returns the whole DP mean."""
    import torch.distributed as dist
    from repro_torch.sharding import spmd
    model = build_model(cfg)
    dp = partition.dp_size(mesh, cfg)
    group = spmd.dp_group(mesh, partition.fsdp_axes(mesh, cfg))
    coord = spmd.coordinate(mesh)

    def mean(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=group)
        return x.div_(dp)

    def grads_fn(params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        m = microbatch_count(cfg, batch["tokens"].shape[0], dp)
        bspecs = partition.batch_specs(batch, cfg, mesh)
        rows = {k: partition.NamedSharding(mesh, bspecs[k]).local_block(
            v, coord) for k, v in batch.items()}
        loss, grads = compute_grads(model, spmd.full_tree(params), rows, m)
        for g in tree_leaves(grads):
            mean(g)
        loss = mean(loss.float().clone())
        if grad_compress is not None:
            grads = grad_compress(grads)
        return loss, grads

    return grads_fn


def build_sharded_train_step(cfg: ModelConfig, mesh,
                             opt: AdamWConfig | None = None,
                             grad_compress: Callable | None = None
                             ) -> Callable:
    """The training step of one rank of ``mesh`` (a ``DeviceMesh`` over an
    initialised process group), SPMD: ``step(params, opt_state, batch)``
    with ``params`` and the moments ``opt_state["m"]`` / ``["v"]`` trees
    of ``DTensor``s stored per ``param_specs`` (``sharding.spmd``),
    ``count`` replicated, and ``batch`` the global batch (every rank
    passes the same one).

    The step takes the loss and the DP-mean gradients from
    ``build_sharded_grads`` and runs AdamW on the rank's blocks with the
    matching blocks of the mean gradients, clipped by the norm of the
    whole mean gradient, so every rank scales alike.  The loss it returns
    is the DP mean.  The model axis shards storage only: its ranks
    compute redundantly."""
    from repro_torch.sharding import spmd
    opt = opt or AdamWConfig()
    grads_fn = build_sharded_grads(cfg, mesh, grad_compress)
    coord = spmd.coordinate(mesh)
    shardings = partition.logical_to_sharding(
        partition.param_specs(param_specs(cfg), cfg, mesh), mesh)

    def train_step(params: dict, opt_state: dict, batch: dict
                   ) -> tuple[dict, dict, dict[str, Any]]:
        loss, grads = grads_fn(params, batch)
        gnorm = global_norm(tree_leaves(grads))
        blocks = tree_map(lambda g, sh: sh.local_block(g, coord), grads,
                          shardings)
        del grads
        _, state = adamw_update(
            opt, spmd.local_tree(params), blocks,
            {"m": spmd.local_tree(opt_state["m"]),
             "v": spmd.local_tree(opt_state["v"]),
             "count": opt_state["count"]}, gnorm=gnorm)
        return params, {"m": opt_state["m"], "v": opt_state["v"],
                        "count": state["count"]}, {"loss": loss}

    return train_step


def build_train_bundle(cfg: ModelConfig, cell: ShapeCell, *, mesh=None,
                       opt: AdamWConfig | None = None,
                       grad_compress: Callable | None = None,
                       device: "torch.device | str | None" = None
                       ) -> StepBundle:
    """``build_train_step`` of ``cell`` as a bundle: meta parameters,
    AdamW state and batch, the parameters and state written in place and,
    with ``mesh``, JAX's shardings: in (params, opt_state, batch), out
    (params, opt_state, {"loss"})."""
    cfg, _, dev = _step_setup(cfg, None, device)
    params = param_specs(cfg)
    batch = input_specs(cfg, cell)["batch"]
    specs = (params, init_opt_state(params, device="meta"), batch)
    in_sh = out_sh = None
    if mesh is not None:
        p = partition.param_specs(params, cfg, mesh)
        o = {"m": p, "v": p, "count": P()}
        in_sh = (p, o, partition.batch_specs(batch, cfg, mesh, cell))
        out_sh = (p, o, {"loss": P()})
    return StepBundle(fn=build_train_step(cfg, opt, grad_compress,
                                          mesh=mesh),
                      arg_specs=specs, donate_argnums=(0, 1), device=dev,
                      in_shardings=in_sh, out_shardings=out_sh)


def _io_shardings(cfg: ModelConfig, cell: ShapeCell, mesh, specs: tuple,
                  batch_like) -> tuple:
    """(in, out) spec trees of a serving step over ``specs`` (params,
    batch or tokens, cache): JAX's ``build_prefill_step`` /
    ``build_serve_step`` shardings; the logits ``[B, 1, padded_vocab]``."""
    p = partition.param_specs(specs[0], cfg, mesh)
    b = partition.batch_specs(batch_like, cfg, mesh, cell)
    c = partition.cache_specs(specs[2], cfg, mesh, cell)
    logits = partition.logits_spec(
        (cell.global_batch, 1, cfg.padded_vocab), cfg, mesh)
    return (p, b, c), (logits, c)


def _step_setup(cfg: ModelConfig, impl: "str | None", device
                ) -> tuple[ModelConfig, Model, torch.device]:
    """``cfg`` with ``attention_impl = impl`` (when given), its model, and
    the step's device: ``"cuda"`` by default (raising without a card),
    ``"cpu"`` or the dry-run's ``"meta"`` when asked, anything else
    raises."""
    dev = resolve_device(device)
    if dev.type not in STEP_DEVICES:
        raise ValueError(f"step device {dev}: one of {STEP_DEVICES}")
    if impl is not None:
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown impl {impl!r}; one of "
                             f"{ATTENTION_IMPLS}")
        cfg = dataclasses.replace(cfg, attention_impl=impl)
    return cfg, build_model(cfg), dev


def build_prefill_step(cfg: ModelConfig, cell: ShapeCell, *,
                       impl: "str | None" = None,
                       device: "torch.device | str | None" = None,
                       mesh=None) -> StepBundle:
    """``prefill_step(params, batch, cache) -> (last logits [B, 1, V],
    cache)`` of ``cell`` (B prompts of ``seq_len`` positions into a cache of
    ``seq_len + DECODE_SLACK`` rows, written in place).  ``impl`` (default
    the config's ``attention_impl``) picks the routes as the model reads
    it: ``"kernel"`` the flash, decode and wkv kernels on the card,
    ``"chunked"`` / ``"naive"`` their plain counterparts (chunked or naive
    prefill attention, the einsum decode, ``wkv_plain``).  ``mesh`` adds
    the shardings."""
    cfg, model, dev = _step_setup(cfg, impl, device)

    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)

    specs = (param_specs(cfg), input_specs(cfg, cell)["batch"],
             cache_spec(cfg, cell.global_batch, cell.seq_len))
    in_sh, out_sh = (None, None) if mesh is None else _io_shardings(
        cfg, cell, mesh, specs, specs[1])
    return StepBundle(fn=prefill_step, arg_specs=specs, donate_argnums=(2,),
                      device=dev, in_shardings=in_sh, out_shardings=out_sh)


def build_serve_step(cfg: ModelConfig, cell: ShapeCell, *,
                     impl: "str | None" = None,
                     device: "torch.device | str | None" = None,
                     mesh=None) -> StepBundle:
    """``serve_step(params, tokens [B, 1], cache) -> (logits [B, 1, V],
    cache)``: one decode step of ``cell`` against a cache of ``seq_len +
    DECODE_SLACK`` rows holding ``seq_len`` tokens (its spec's ``length``),
    the new row written in place.  ``impl``, ``device`` and ``mesh`` as in
    ``build_prefill_step``."""
    cfg, model, dev = _step_setup(cfg, impl, device)

    def serve_step(params, tokens, cache):
        return model.decode_step(params, tokens, cache)

    specs = input_specs(cfg, cell)
    cache = dataclasses.replace(specs["cache"], length=cell.seq_len)
    args = (param_specs(cfg), specs["tokens"], cache)
    in_sh, out_sh = (None, None) if mesh is None else _io_shardings(
        cfg, cell, mesh, args, {"tokens": args[1]})
    if in_sh is not None:
        in_sh = (in_sh[0], in_sh[1]["tokens"], in_sh[2])
    return StepBundle(fn=serve_step, arg_specs=args, donate_argnums=(2,),
                      device=dev, in_shardings=in_sh, out_shardings=out_sh)
