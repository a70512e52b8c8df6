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

On a ``DeviceMesh`` (over an initialised process group; the dry-run's
fake group of 256 or 512 ranks too) each builder returns one rank's step
instead: its arguments are the rank's blocks per the specs, plain tensors
of their local shapes (``arg_specs`` holds meta tensors of those shapes),
and its outputs are the rank's blocks of the out shardings' specs.  Every
family's step partitions its compute over the model axis and gathers
each layer's FSDP blocks over the DP axes where the layer uses them
(``PARTITIONED_FAMILIES``: the transformer's families, rwkv6, zamba2 and
enc-dec; each model's docstring says how); ``model_axis(cfg)`` says so.
Under the ``sequence_parallel`` hint the transformer families' steps
split the residual stream's sequence over the model axis as well (under
``zero3`` too); a train or prefill step whose batch rows take the model
axis there raises ``ValueError`` when built, as JAX's constraint does
(``check_sequence_axis``).
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
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.sharding import partition
from repro_torch.sharding.partition import PartitionSpec as P
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["build_train_step", "build_train_bundle",
           "build_sharded_grads", "build_sharded_train_step",
           "build_prefill_step",
           "build_serve_step", "StepBundle", "microbatch_count",
           "compute_grads", "model_axis", "local_specs",
           "check_sequence_axis", "PARTITIONED_FAMILIES",
           "SEQUENCE_FAMILIES"]

STEP_DEVICES = ("cuda", "cpu", "meta")
# the families whose rank's step partitions its compute over the model axis
PARTITIONED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def model_axis(cfg: ModelConfig) -> str:
    """What the model axis does in a rank's step of ``cfg``: ``"compute"``
    (its products partitioned over it), for every family the port runs;
    another raises ``NotImplementedError``."""
    if cfg.family not in PARTITIONED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r}: no partitioned "
                                  f"step")
    return "compute"


# the families whose residual stream JAX constrains under the
# ``sequence_parallel`` hint (the others never read it)
SEQUENCE_FAMILIES = ("dense", "moe", "vlm")


def check_sequence_axis(cfg: ModelConfig, mesh, batch: dict,
                        rows: int) -> None:
    """Raise ``ValueError`` where the ``sequence_parallel`` hint puts the
    sequence of ``batch`` (a train or prefill batch, or its meta stand-in)
    on the model axis while ``rows`` batch rows (a microbatch's) take it
    too: ``zero3``'s DP axes end in the model axis
    (``partition.sequence_axis``, JAX's ``DuplicateSpecError``)."""
    if cfg.family not in SEQUENCE_FAMILIES:
        return
    s = batch["tokens"].shape[1]
    if "patch_embeds" in batch:
        s += batch["patch_embeds"].shape[1]
    partition.sequence_axis(cfg, mesh, rows, s)


def _microbatch_rows(cfg: ModelConfig, mesh, global_batch: int) -> int:
    """A microbatch's rows of the train step's ``global_batch``."""
    dp = partition.dp_size(mesh, cfg)
    return global_batch // microbatch_count(cfg, global_batch, dp)


def _on_groups(mesh) -> bool:
    """A ``DeviceMesh`` with process groups (an ``AbstractMesh`` has
    names and sizes only)."""
    return mesh is not None and hasattr(mesh, "get_group")


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


def _rank_rows(batch: dict, cfg: ModelConfig, mesh, coord) -> dict:
    """The rank's rows of the global ``batch`` per ``batch_specs``."""
    bspecs = partition.batch_specs(batch, cfg, mesh)
    return {k: partition.NamedSharding(mesh, bspecs[k]).local_block(
        v, coord) for k, v in batch.items()}


def _rank_grads(cfg: ModelConfig, mesh, grad_compress: Callable | None):
    """``grads(params, rows, global_batch) -> (loss, grads)`` of one rank:
    ``params`` the rank's blocks (plain tensors), ``rows`` its batch rows,
    ``global_batch`` the step's whole batch size (the microbatch count is
    ``microbatch_count`` at the mesh's DP size).  The loss is the DP mean;
    the gradients are the rank's blocks of the DP-mean gradient.

    The model runs under the rank's ``api.ComputeAxes``, its FSDP
    gathers' backward passes reduce-scatter the gradients over the DP
    group -- each block comes back as the DP sum of its gradients, with
    no whole gradient on any rank -- and ``spmd.dp_mean`` all-reduces the
    leaves the DP axes leave whole and divides by the DP size.  A
    reduce-scatter and not an all-reduce and a slice: each rank keeps
    only its block, so it need not receive the rest.

    ``grad_compress`` (the approximate collective's quantize round trip)
    applies to each whole mean gradient, as JAX applies it to the global
    array: its quantize tiles span the whole flattened leaf, so a split
    leaf is gathered for it and cut back into the rank's block."""
    from repro_torch.sharding import api, spmd
    from repro_torch.sharding.collectives import all_reduce
    model = build_model(cfg)
    pshape = param_specs(cfg)
    specs = partition.param_specs(pshape, cfg, mesh)
    shardings = partition.logical_to_sharding(specs, mesh)
    axes = spmd.compute_axes(mesh, cfg, pshape)
    coord = spmd.coordinate(mesh)
    dp = axes.dp_size

    def whole(tree):
        return tree_map(lambda x, sp: spmd.gather_whole(x, sp, mesh), tree,
                        specs)

    def blocks(tree):
        return tree_map(lambda g, sh: sh.local_block(g, coord), tree,
                        shardings)

    def grads_fn(params: dict, rows: dict, global_batch: int
                 ) -> tuple[torch.Tensor, dict]:
        check_sequence_axis(cfg, mesh, rows,
                            _microbatch_rows(cfg, mesh, global_batch))
        m = microbatch_count(cfg, global_batch, dp)
        with api.active(mesh, axes):
            loss, grads = compute_grads(model, params, rows, m)
        grads = spmd.dp_mean(grads, axes)
        if grad_compress is not None:
            grads = blocks(grad_compress(whole(grads)))
        loss = all_reduce(loss.float().clone(), axes.dp_group)
        return (loss.div_(dp) if dp > 1 else loss), grads

    grads_fn.axes = axes
    return grads_fn


def _rank_train_step(cfg: ModelConfig, mesh, opt: AdamWConfig | None,
                     grad_compress: Callable | None) -> Callable:
    """``step(params, opt_state, rows, global_batch)`` of one rank over its
    plain blocks: ``_rank_grads``, then AdamW on the blocks clipped by the
    norm of the whole mean gradient (``spmd.global_norm``: one all-reduce
    of the blocks' sums of squares), so every rank scales alike."""
    from repro_torch.sharding import spmd
    opt = opt or AdamWConfig()
    grads_fn = _rank_grads(cfg, mesh, grad_compress)

    def step(params: dict, opt_state: dict, rows: dict, global_batch: int
             ) -> tuple[dict, dict, dict[str, Any]]:
        loss, grads = grads_fn(params, rows, global_batch)
        gnorm = spmd.global_norm(grads, grads_fn.axes)
        params, state = adamw_update(opt, params, grads, opt_state,
                                     gnorm=gnorm)
        return params, state, {"loss": loss}

    return step


def build_sharded_grads(cfg: ModelConfig, mesh,
                        grad_compress: Callable | None = None
                        ) -> Callable:
    """The first half of ``build_sharded_train_step``:
    ``grads(params, batch) -> (loss, grads)`` of one rank of ``mesh`` (a
    ``DeviceMesh`` over an initialised process group), with ``params`` a
    tree of ``DTensor``s stored per ``param_specs`` and ``batch`` the
    global batch (every rank passes the same one).

    It takes the rank's rows of the batch per ``batch_specs`` (over the DP
    axes, so the model-axis ranks of one DP group share rows; over every
    axis under ``zero3``) and runs ``_rank_grads`` on the rank's blocks:
    the partitioned compute, whose gradients come back as the rank's
    blocks of the DP mean without a whole parameter or gradient on any
    rank.  Returns the DP-mean loss and the mean gradient as ``DTensor``s
    of the rank's blocks, placed as the parameters (``full_tensor()``
    gathers one whole)."""
    from repro_torch.sharding import spmd
    grads_fn = _rank_grads(cfg, mesh, grad_compress)
    coord = spmd.coordinate(mesh)
    shardings = partition.logical_to_sharding(
        partition.param_specs(param_specs(cfg), cfg, mesh), mesh)

    def sharded_grads(params: dict, batch: dict
                      ) -> tuple[torch.Tensor, dict]:
        loss, grads = grads_fn(spmd.local_tree(params),
                               _rank_rows(batch, cfg, mesh, coord),
                               batch["tokens"].shape[0])
        return loss, spmd.blocks_as_dtensors(grads, shardings, params)

    return sharded_grads


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

    The step runs ``_rank_train_step`` on the rank's blocks and its batch
    rows: the DP-mean loss and gradient blocks of ``_rank_grads`` (the
    compute partitioned over the model axis, each rank computing its
    heads, FFN columns, experts and vocabulary block), then AdamW on the
    blocks, clipped by the norm of the whole mean gradient.  The loss it
    returns is the DP mean."""
    from repro_torch.sharding import spmd
    step = _rank_train_step(cfg, mesh, opt, grad_compress)
    coord = spmd.coordinate(mesh)

    def train_step(params: dict, opt_state: dict, batch: dict
                   ) -> tuple[dict, dict, dict[str, Any]]:
        _, state, metrics = step(
            spmd.local_tree(params),
            {"m": spmd.local_tree(opt_state["m"]),
             "v": spmd.local_tree(opt_state["v"]),
             "count": opt_state["count"]},
            _rank_rows(batch, cfg, mesh, coord), batch["tokens"].shape[0])
        return params, {"m": opt_state["m"], "v": opt_state["v"],
                        "count": state["count"]}, metrics

    return train_step


def local_specs(tree: Any, specs: Any, mesh) -> Any:
    """Meta stand-ins of one rank's blocks of ``tree`` (meta tensors, in
    tuples, dicts and dataclasses; a dataclass's int fields kept) per ``specs``
    (the tree's ``PartitionSpec``s) on ``mesh``."""
    if isinstance(tree, dict):
        return {k: local_specs(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(local_specs(v, sp, mesh) for v, sp in zip(tree, specs))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: local_specs(getattr(tree, f.name),
                                getattr(specs, f.name), mesh)
            for f in dataclasses.fields(tree)})
    if not isinstance(tree, torch.Tensor):
        return tree
    shape = partition.NamedSharding(mesh, specs).local_shape(tree.shape)
    return torch.empty(shape, dtype=tree.dtype, device=tree.device)


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
    fn = None
    if mesh is not None:
        check_sequence_axis(cfg, mesh, batch, _microbatch_rows(
            cfg, mesh, cell.global_batch))
        p = partition.param_specs(params, cfg, mesh)
        o = {"m": p, "v": p, "count": P()}
        in_sh = (p, o, partition.batch_specs(batch, cfg, mesh, cell))
        out_sh = (p, o, {"loss": P()})
        if _on_groups(mesh):
            specs = local_specs(specs, in_sh, mesh)
            step = _rank_train_step(cfg, mesh, opt, grad_compress)

            def fn(params, opt_state, batch):
                return step(params, opt_state, batch, cell.global_batch)
    if fn is None:
        fn = build_train_step(cfg, opt, grad_compress, mesh=mesh)
    return StepBundle(fn=fn, arg_specs=specs, donate_argnums=(0, 1),
                      device=dev, in_shardings=in_sh, out_shardings=out_sh)


def _rank_serving(cfg: ModelConfig, mesh, shardings: tuple, whole: tuple,
                  run: Callable) -> Callable:
    """One rank's serving step ``(params, inputs, cache) -> (logits,
    cache)`` over its blocks, ``run(params, inputs, cache)`` being the
    model's prefill or decode step and ``whole`` the meta stand-ins of its
    whole arguments: ``run`` under the rank's ``api.ComputeAxes``, which
    say which cache fields lie on the model axis (``cache_specs``), on
    the whole batch where the logits hold it whole."""
    from repro_torch.sharding import api, spmd
    (_, ispecs, cspecs), (lspec, _) = shardings
    axes = spmd.compute_axes(mesh, cfg, whole[0], cache_specs=cspecs)
    # the cache and the logits take the batch over every DP axis or none
    # (``cache_specs``, ``logits_spec``), the inputs over the longest
    # prefix of them that divides it (``batch_specs``): where the outputs
    # hold the batch whole, a rank gathers the rows the inputs split
    whole_batch = not partition._axes_of(lspec[0])

    def rows_whole(inputs):
        if not isinstance(inputs, dict):
            return spmd.gather_whole(inputs, ispecs, mesh)
        return {k: spmd.gather_whole(x, ispecs[k], mesh) if k in ispecs
                else x for k, x in inputs.items()}

    def partitioned(params, inputs, cache):
        if whole_batch:
            inputs = rows_whole(inputs)
        with api.active(mesh, axes):
            return run(params, inputs, cache)
    return partitioned


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
    if mesh is not None:
        check_sequence_axis(cfg, mesh, specs[1], cell.global_batch)
    in_sh, out_sh = (None, None) if mesh is None else _io_shardings(
        cfg, cell, mesh, specs, specs[1])
    fn = prefill_step
    if _on_groups(mesh):
        fn = _rank_serving(cfg, mesh, (in_sh, out_sh), specs,
                           model.prefill)
        specs = local_specs(specs, in_sh, mesh)
    return StepBundle(fn=fn, arg_specs=specs, donate_argnums=(2,),
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
    fn = serve_step
    if _on_groups(mesh):
        fn = _rank_serving(cfg, mesh, (in_sh, out_sh), args,
                           model.decode_step)
        args = local_specs(args, in_sh, mesh)
    return StepBundle(fn=fn, arg_specs=args, donate_argnums=(2,),
                      device=dev, in_shardings=in_sh, out_shardings=out_sh)
