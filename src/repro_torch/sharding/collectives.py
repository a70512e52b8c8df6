"""The collectives of a rank's partitioned step, and Megatron's pairs of
them as autograd functions.

The JAX package has no counterpart: there GSPMD inserts the collectives
of a partitioned program.  Here each rank runs a program on its own
blocks, as plain tensors of their local shapes, and the collectives are
explicit.  Every one goes through ``torch.ops._c10d_functional`` (the ops
``torch.distributed._functional_collectives`` wraps) and is waited on at
once, so a dispatch mode such as ``meta.MetaPass`` sees each as one
operation it can count, and a fake process group of 256 or 512 ranks runs
them on meta tensors in one process.

A group of one rank (or ``None``) issues nothing: every function returns
its input (or, where it makes a new tensor, a copy-free view of it).

Two ranks on one card.  NCCL refuses two ranks on one device, so the
model axis at 2 on the one card runs over gloo, and gloo's
``all_gather_into_tensor`` on CUDA tensors kills the process (SIGSEGV,
torch 2.11.0+cu128; PERF.md, Findings).  So where the group's
backend is gloo and the tensor lies on a card, the plain collectives
carry a host copy and copy the result back to the tensor's device: a
transport, the compute staying on the card.  NCCL groups, CPU tensors
and meta tensors (``meta.MetaPass``'s fake group, which counts each
collective once) take the functional op directly.

Plain (no gradient of their own):

  all_reduce(x, group, op)      sum / max over the group
  all_gather(x, dim, group)     the group's blocks concatenated along dim
  reduce_scatter(x, dim, group) the sum over the group, this rank's block
  all_to_all(x, split, cat, group)
                                block j of dim ``split`` to rank j, the
                                blocks received concatenated along ``cat``
  counted_once(x, group)        identity forward, the gradient divided by
                                the group's size backward (no collective)

With autograd (the model axis's pairs, and FSDP's gather):

  copy_to(x, group)        identity forward, all-reduce backward (Megatron's
                           ``f``: a replicated value entering compute that
                           each rank does a part of)
  reduce_from(x, group)    all-reduce forward, identity backward (``g``:
                           the partial sums of a row-parallel product)
  gather_from(x, dim, group)
                           all-gather forward, this rank's slice backward
                           (the gathered value is used alike on every rank)
  gather_summed(x, dim, group)
                           all-gather forward, reduce-scatter backward (the
                           gathered value is used in parts: each rank's
                           gradient of it is a partial sum; FSDP's weights)
  scatter_from(x, dim, group)
                           reduce-scatter forward, all-gather backward (the
                           partial sums of a row-parallel product, each
                           rank keeping its block of the sum)
"""

from __future__ import annotations

import torch

__all__ = ["size", "rank", "all_reduce", "all_gather", "reduce_scatter",
           "all_to_all", "host_staged", "counted_once", "copy_to",
           "reduce_from", "gather_from",
           "gather_summed", "scatter_from", "KINDS", "OP_KINDS"]

# JAX's collective kinds (``parse_collectives``), and the functional ops
# that issue each here
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
OP_KINDS = {"all_gather_into_tensor": "all-gather",
            "all_reduce": "all-reduce",
            "reduce_scatter_tensor": "reduce-scatter",
            "all_to_all_single": "all-to-all"}


def _ops():
    # importing the module registers the ops' meta kernels
    import torch.distributed._functional_collectives  # noqa: F401
    return torch.ops._c10d_functional


def size(group) -> int:
    """The group's rank count (1 for ``None``)."""
    if group is None:
        return 1
    return group.size()


def rank(group) -> int:
    """This process's rank in ``group`` (0 for ``None``)."""
    if group is None:
        return 0
    import torch.distributed as dist
    return dist.get_rank(group)


def _backend(group) -> str:
    import torch.distributed as dist
    return dist.get_backend(group)


def host_staged(x: torch.Tensor, group) -> bool:
    """Whether a collective of ``x`` over ``group`` runs on a host copy:
    ``x`` on a card and ``group`` a gloo group (see the module
    docstring)."""
    return x.device.type == "cuda" and _backend(group) == "gloo"


def _run(x: torch.Tensor, group, op) -> torch.Tensor:
    """``op(x)`` (a functional collective, waited on), on a host copy of
    ``x`` with the result copied back where ``host_staged``."""
    if host_staged(x, group):
        return op(x.cpu()).to(x.device)
    return op(x)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum" or "max") of ``x`` over ``group``, a new tensor."""
    if size(group) == 1:
        return x
    ops = _ops()
    return _run(x.contiguous(), group, lambda t: ops.wait_tensor(
        ops.all_reduce(t, op, group.group_name)))


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in group
    rank order."""
    m = size(group)
    if m == 1:
        return x
    ops = _ops()
    out = _run(x.contiguous(), group, lambda t: ops.wait_tensor(
        ops.all_gather_into_tensor(t, m, group.group_name)))
    dim = dim % x.dim()
    shape = list(x.shape)
    out = out.view(m, *shape).movedim(0, dim)
    shape[dim] *= m
    return out.reshape(shape)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, cut into the group's blocks along
    ``dim``: this rank's block."""
    m = size(group)
    if m == 1:
        return x
    ops = _ops()
    dim = dim % x.dim()
    shape = list(x.shape)
    if shape[dim] % m:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(shape)} does "
                         f"not split {m} ways")
    shape[dim] //= m
    blocks = x.reshape(*x.shape[:dim], m, shape[dim], *x.shape[dim + 1:])
    blocks = blocks.movedim(dim, 0).contiguous()
    out = _run(blocks.view(m, -1), group, lambda t: ops.wait_tensor(
        ops.reduce_scatter_tensor(t, "sum", m, group.group_name)))
    return out.view(shape)


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, group
               ) -> torch.Tensor:
    """Block ``j`` of ``x`` along ``split_dim`` to rank ``j``; the blocks
    this rank receives, concatenated along ``cat_dim`` in group rank
    order."""
    m = size(group)
    if m == 1:
        return x
    ops = _ops()
    split_dim, cat_dim = split_dim % x.dim(), cat_dim % x.dim()
    n = x.shape[split_dim] // m
    blocks = x.reshape(*x.shape[:split_dim], m, n, *x.shape[split_dim + 1:])
    blocks = blocks.movedim(split_dim, 0).contiguous()
    out = _run(blocks, group, lambda t: ops.wait_tensor(
        ops.all_to_all_single(t, [1] * m, [1] * m, group.group_name)))
    # out[i] is rank i's block j; put i beside cat_dim and merge them
    rest = list(x.shape)
    rest[split_dim] = n
    out = out.reshape(m, *rest).movedim(0, cat_dim)
    rest[cat_dim] *= m
    return out.reshape(rest)


def _own(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    m = size(group)
    n = x.shape[dim] // m
    return x.narrow(dim, rank(group) * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.dim, ctx.group).contiguous(), None, None


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _CountedOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m):
        ctx.m = m
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.m, None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def counted_once(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, its gradient divided by the group's size: a value every rank
    of ``group`` uses alike, whose (whole, equal) gradient joins the
    ranks' partial ones into a reduce-scatter's sum, which then counts it
    once (the MoE router's input under sequence parallelism)."""
    if size(group) == 1 or not _differentiable(x):
        return x
    return _CountedOnce.apply(x, size(group))


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (replicated over ``group``), its gradient summed over the
    group in the backward pass."""
    if size(group) == 1 or not _differentiable(x):
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's partial ``x``; the gradient passes as it is
    (every rank's is the whole one)."""
    if size(group) == 1:
        return x
    if not _differentiable(x):
        return all_reduce(x, group)
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks concatenated along ``dim``; the gradient of this
    rank's block is its slice of the gathered value's (used alike on every
    rank)."""
    if size(group) == 1:
        return x
    if not _differentiable(x):
        return all_gather(x, dim, group)
    return _GatherFrom.apply(x, dim, group)


def gather_summed(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks concatenated along ``dim``; the gradient of this
    rank's block is its block of the group's summed gradients (each rank
    uses the gathered value in its own part of the work)."""
    if size(group) == 1:
        return x
    if not _differentiable(x):
        return all_gather(x, dim, group)
    return _GatherSummed.apply(x, dim, group)


def scatter_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of the group's partial
    ``x``; the gradient of ``x`` is the group's blocks of the gradient
    gathered (every rank's partial ``x`` reaches every block)."""
    if size(group) == 1:
        return x
    if not _differentiable(x):
        return reduce_scatter(x, dim, group)
    return _ScatterFrom.apply(x, dim, group)
