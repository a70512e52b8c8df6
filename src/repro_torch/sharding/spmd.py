"""SPMD state on a ``DeviceMesh``, and what a rank's partitioned step
needs of it.

Storage: each rank holds, for every leaf, its block of the whole tensor
per ``partition.param_specs`` as a ``DTensor`` (``shard_tree``; the
AdamW moments mirror the parameters, ``count`` is a replicated plain
tensor).  ``full_tree`` gathers whole tensors for a checkpoint or a
caller's ``return_params``; no step computes on it.

Compute (``launch/steps.py``): a rank's step takes the plain local blocks
(``local_tree``) and the rank's ``api.ComputeAxes`` (``compute_axes``: the
model axis's group, the DP axes' group, each leaf's ``LeafPlan``).  A
layer gathers a weight's FSDP block over the DP group where it uses it
(``fsdp_gather``, inside the layer, so a ``remat`` block gathers again in
its recomputation and the gathered copy is freed after the layer) and
keeps its model-axis block.  The backward pass of that gather is a
reduce-scatter over the DP group, so a leaf's gradient comes back as the
rank's block of the DP sum; a leaf the DP axes leave whole gets its sum
by an all-reduce (``dp_mean``, which also divides by the DP size).
Every family partitions its compute so; ``gather_whole`` gathers a whole
tensor from its blocks only for the approximate collective's quantize
round trip, which JAX applies to the whole mean gradient.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import numpy as np
import torch

from repro_torch.sharding import partition
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["coordinate", "dp_group", "shard_tree", "full_tree",
           "local_tree", "zeros_like_tree", "resident_elements",
           "spec_elements", "compute_axes", "fsdp_gather", "gather_whole",
           "dp_mean", "global_norm", "blocks_as_dtensors"]


def coordinate(mesh) -> dict:
    """This rank's index on every mesh axis, by name."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def dp_group(mesh, axes: tuple):
    """The process group of this rank's data-parallel peers: the ranks
    whose coordinates differ from its own only on ``axes``.  Every rank
    creates every group, in one order, as ``torch.distributed.new_group``
    asks."""
    import torch.distributed as dist
    names = tuple(mesh.mesh_dim_names)
    ranks = np.asarray(mesh.mesh.cpu().numpy())
    dims = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in dims]
    size = math.prod(ranks.shape[d] for d in dims)
    rows = np.transpose(ranks, rest + dims).reshape(-1, size)
    me, mine = dist.get_rank(), None
    for row in rows:
        group = dist.new_group([int(r) for r in row])
        if me in row:
            mine = group
    return mine


def shard_tree(tree, shardings):
    """Every whole tensor of ``tree`` as the ``DTensor`` of its block on
    this rank (``partition.NamedSharding.distribute``)."""
    return tree_map(lambda x, sh: sh.distribute(x), tree, shardings)


def full_tree(tree):
    """The whole tensors of a tree of ``DTensor``s (all-gathers)."""
    return tree_map(lambda x: x.full_tensor(), tree)


def local_tree(tree):
    """The local blocks of a tree of ``DTensor``s: the tensors they store
    (writes to them are writes to the ``DTensor``s)."""
    return tree_map(lambda x: x.to_local(), tree)


def zeros_like_tree(tree, dtype=torch.float32):
    """Zero ``DTensor``s of ``tree``'s shapes and placements in ``dtype``
    (the AdamW moments of a sharded parameter tree)."""
    from torch.distributed.tensor import DTensor

    def zeros(x):
        local = torch.zeros(x.to_local().shape, dtype=dtype,
                            device=x.to_local().device)
        return DTensor.from_local(local, x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    return tree_map(zeros, tree)


def resident_elements(tree) -> int:
    """Elements this rank stores for a tree of ``DTensor``s."""
    return sum(x.to_local().numel() for x in tree_leaves(tree))


def spec_elements(tree, specs, mesh) -> int:
    """Elements one rank's share of ``tree`` holds per ``specs`` on
    ``mesh``: each leaf's size over its specs' shard count."""
    total = 0
    for x, spec in zip(tree_leaves(tree), partition.spec_leaves(specs)):
        shape = partition.NamedSharding(mesh, spec).local_shape(x.shape)
        total += math.prod(shape)
    return total


_GROUPS: dict = {}      # id(mesh) -> (ref to the mesh, its world, groups)


def _dp_group_cached(mesh, axes: tuple):
    """``dp_group(mesh, axes)``, made once a mesh and process group (every
    rank makes the groups in one order, so the first call is collective).
    Keyed by the mesh object, not its layout: a mesh of the same layout
    over a later process group (the dry-run's fake group is made anew a
    cell) gets groups of its own."""
    import torch.distributed as dist
    ref, world, cache = _GROUPS.get(id(mesh), (None, None, None))
    if ref is None or ref() is not mesh or world is not dist.group.WORLD:
        cache = {}
        _GROUPS[id(mesh)] = (weakref.ref(mesh), dist.group.WORLD, cache)
    if axes not in cache:
        cache[axes] = (mesh.get_group(axes[0]) if len(axes) == 1
                       else dp_group(mesh, axes))
    return cache[axes]


def _cache_dims(specs, prefix: str = "") -> dict:
    """``{field: dim}`` of a cache's spec tree (nested dataclasses): each
    field whose spec puts a dim on the model axis."""
    out = {}
    if specs is None:
        return out
    for f in dataclasses.fields(specs):
        spec = getattr(specs, f.name)
        name = prefix + f.name
        if dataclasses.is_dataclass(spec):
            out.update(_cache_dims(spec, name + "/"))
        elif isinstance(spec, tuple):
            dims = [d for d, e in enumerate(spec)
                    if "model" in partition._axes_of(e)]
            if dims:
                out[name] = dims[0]
    return out


def compute_axes(mesh, cfg, params_shape, *, cache_specs=None):
    """This rank's ``api.ComputeAxes`` on ``mesh`` (a ``DeviceMesh``) for
    ``cfg``'s parameter tree ``params_shape``: the model axis's group
    (``None`` under ``zero3``, which folds it into DP), the DP axes' group,
    every leaf's ``LeafPlan``, for a serving step which fields of its
    cache (``cache_specs``, the cache's spec tree) the model axis splits,
    and under the ``sequence_parallel`` hint the model axis's group as the
    sequence's (``zero3`` too)."""
    from repro_torch.sharding.api import ComputeAxes
    from repro_torch.sharding.collectives import rank, size
    names = tuple(mesh.mesh_dim_names)
    dp = partition.fsdp_axes(mesh, cfg)
    model = seq = None
    if "model" in names:
        axis = mesh.get_group("model")
        model = None if cfg.zero3 else axis
        seq = axis if cfg.sequence_parallel else None
    dpg = _dp_group_cached(mesh, dp) if dp else None
    return ComputeAxes(model_group=model, model_size=size(model),
                       model_rank=rank(model), dp=dp, dp_group=dpg,
                       dp_size=size(dpg),
                       plans=partition.leaf_plans(params_shape, cfg, mesh),
                       cache_dims=_cache_dims(cache_specs),
                       seq_group=seq, seq_size=size(seq),
                       seq_rank=rank(seq))


def fsdp_gather(tree, axes, prefix: tuple = ()):
    """Every leaf of ``tree`` (a dict, a layer's under ``prefix =
    ("layers",)``) with its FSDP block gathered over the DP group
    (``collectives.gather_summed``: the backward pass reduce-scatters the
    gradient); leaves the DP axes leave whole, as they are."""
    from repro_torch.sharding.collectives import gather_summed

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        plan = axes.plan(path)
        if plan is None or plan.dp_dim is None:
            return node
        return gather_summed(node, plan.dp_dim, axes.dp_group)
    return walk(tree, tuple(prefix))


def gather_whole(x: torch.Tensor, spec, mesh):
    """The whole tensor of the block ``x`` holds per ``spec`` on ``mesh``:
    one all-gather a split dimension, over the group of the axes that
    split it."""
    from repro_torch.sharding.collectives import all_gather
    for d, entry in enumerate(spec):
        axes = partition._axes_of(entry)
        if not axes:
            continue
        group = (mesh.get_group(axes[0]) if len(axes) == 1
                 else _dp_group_cached(mesh, tuple(axes)))
        x = all_gather(x, d, group)
    return x


def dp_mean(grads: dict, axes, scale: float = 1.0) -> dict:
    """The DP mean of a rank's gradient blocks: the leaves the DP axes
    leave whole are summed over the DP group (an all-reduce: their
    gradients are each DP rank's own), the FSDP leaves came summed from
    their gathers' reduce-scatters; all are divided by the DP size (and
    multiplied by ``scale``)."""
    from repro_torch.sharding.collectives import all_reduce
    factor = scale / axes.dp_size

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        plan = axes.plan(path)
        if plan is None or plan.dp_dim is None:
            node = all_reduce(node, axes.dp_group)
        return node.mul_(factor) if factor != 1.0 else node
    return walk(grads, ())


def global_norm(grads: dict, axes) -> torch.Tensor:
    """The global norm of the whole gradient from the rank's blocks: each
    leaf's float32 sum of squares (leaf by leaf in sorted-key order, as
    ``optim.adamw.global_norm``) over its replica count (the ranks that
    hold the same block), summed over every rank by one all-reduce."""
    import torch.distributed as dist
    from repro_torch.sharding.collectives import all_reduce
    from repro_torch.tree import tree_items
    world = dist.get_world_size()
    total = None
    for key, g in tree_items(grads):
        plan = axes.plan(tuple(key.split("/")))
        shards = ((axes.dp_size if plan.dp_dim is not None else 1)
                  * (axes.model_size if plan.model_dim is not None else 1))
        sq = g.to(torch.float32, copy=True).square_().sum()
        if shards != world:
            sq = sq * (shards / world)
        total = sq if total is None else total + sq
    return torch.sqrt(all_reduce(total, dist.group.WORLD))


def blocks_as_dtensors(blocks, shardings, like):
    """A tree of the rank's blocks as ``DTensor``s placed as ``shardings``
    say, of the whole shapes of ``like``'s leaves."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda b, sh, x: DTensor.from_local(
        b, sh.mesh, sh.placements, run_check=False, shape=x.shape,
        stride=x.stride()), blocks, shardings, like)
