"""SPMD training state on a ``DeviceMesh``: parameters and AdamW moments
stored as the specs say, one process a rank.

Each rank holds, for every leaf, its block of the whole tensor per
``partition.param_specs`` as a ``DTensor`` (``shard_tree``; the moments
mirror the parameters, ``count`` is a replicated plain tensor), gathers
the whole tree for a step (``full_tree``, DTensor's all-gathers over the
mesh's dimensions), and averages gradients over its data-parallel group
(``dp_group``: the ranks that differ only in the DP axes' coordinates).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.sharding import partition
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["coordinate", "dp_group", "shard_tree", "full_tree",
           "local_tree", "zeros_like_tree", "resident_elements",
           "spec_elements"]


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
