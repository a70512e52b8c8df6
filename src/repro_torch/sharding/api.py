"""The activated mesh: what a rank's partitioned layers read.

The port of the JAX package's ``sharding/api.py``.  There, model code calls
``shard(x, "dp", None, "model")`` at key activation points and, under an
activated mesh, GSPMD partitions the products by the constraints.  Here
each rank runs its own program on its own blocks with explicit
collectives (``sharding/collectives.py``), and the layers read the mesh
from this module: ``compute_axes()`` gives, while a partitioned step runs
(``launch/steps.py`` enters ``active(...)`` around it), the model axis,
its process group, size and this rank's index on it, the DP axes
(``("pod", "data")`` flattened, all three under ``zero3``) and their
group and size, each parameter leaf's ``partition.LeafPlan``, which
cache fields lie on the model axis and, under the ``sequence_parallel``
hint, the group the sequence splits over (``seq_split``).  Without an active
mesh (or on an ``AbstractMesh``, which has no groups) it is ``None`` and
every layer runs unpartitioned, as before.

``activate`` / ``active_axes`` keep JAX's record of the mesh's DP and model
axes and sizes, and ``shard`` stays a check of one role a dimension, as
JAX's assert is, returning ``x`` unchanged: a rank's tensors are already
its blocks, so there is no layout to pin.

The record is process-wide, not a thread's: one process is one rank, and
autograd runs a CUDA backward pass (with a ``remat`` block's recomputed
forward) on a thread of its own, which must read the same mesh.

Roles per dim: "dp" (pod+data, all three axes under zero3), "model", None.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types

from repro_torch.sharding.partition import mesh_axes

__all__ = ["activate", "deactivate", "shard", "active_axes", "active",
           "compute_axes", "ComputeAxes"]

_ctx = types.SimpleNamespace(on=False, compute=None)


@dataclasses.dataclass(frozen=True)
class ComputeAxes:
    """One rank's view of an activated ``DeviceMesh``: the groups its
    collectives run over.  ``model_group`` is ``None`` where the model
    axis takes no part in compute (absent, or folded into DP under
    ``zero3``); ``plans`` maps a parameter's path (a layer's leaves by
    their path inside the layer, the ``[L]`` axis dropped) to its
    ``partition.LeafPlan``; ``cache_dims`` maps a cache field (its
    dataclass field names, nested ones joined by ``/``: ``"k"``,
    ``"cross_k"``, ``"ssm/conv"``) to the dim ``partition.cache_specs``
    puts on the model axis, for the fields it splits there.

    ``seq_group`` is the model axis's group where the config takes the
    ``sequence_parallel`` hint (``None`` otherwise), under ``zero3`` too:
    JAX's ``shard(h, "dp", "model", None)`` puts the residual stream's
    sequence on the model axis there, with the weights gathered whole
    over every axis.  The transformer families read it
    (``seq_split``); the others ignore the hint, as JAX's do."""
    model_group: object
    model_size: int
    model_rank: int
    dp: tuple
    dp_group: object
    dp_size: int
    plans: dict
    cache_dims: dict = dataclasses.field(default_factory=dict)
    seq_group: object = None
    seq_size: int = 1
    seq_rank: int = 0

    def plan(self, path: tuple):
        return self.plans.get(tuple(path))

    def cache_split(self, field: str) -> bool:
        """Whether the cache field ``field`` is split over the model
        axis."""
        return field in self.cache_dims

    def seq_split(self, s: int) -> bool:
        """Whether a sequence of ``s`` positions lies split over
        ``seq_group``, ``s / seq_size`` rows a rank: where the hint gives
        a group of more than one rank and ``s`` divides it (else JAX's
        ``shard`` leaves the dim whole)."""
        return self.seq_size > 1 and s % self.seq_size == 0

    def own_rows(self, s: int) -> tuple:
        """(first row, rows) of the rank's block of a split sequence of
        ``s`` positions."""
        n = s // self.seq_size
        return self.seq_rank * n, n


def activate(mesh, *, zero3: bool = False, compute: "ComputeAxes | None"
             = None) -> None:
    """Record ``mesh``'s axes (an ``AbstractMesh`` or a ``DeviceMesh``)
    and, for a partitioned step, the rank's ``compute`` axes."""
    axes = mesh_axes(mesh)
    names = ("pod", "data", "model") if zero3 else ("pod", "data")
    _ctx.dp = tuple(n for n in names if n in axes.axis_names)
    # under zero3 the model axis is free for sequence sharding
    _ctx.model = "model" if "model" in axes.axis_names else None
    _ctx.sizes = dict(axes.shape)
    _ctx.mesh = mesh
    _ctx.compute = compute
    _ctx.on = True


def deactivate() -> None:
    _ctx.on = False
    _ctx.compute = None


def active_axes() -> dict | None:
    """``{"dp", "model", "sizes"}`` of the activated mesh, else None."""
    if not _ctx.on:
        return None
    return {"dp": _ctx.dp, "model": _ctx.model, "sizes": _ctx.sizes}


def compute_axes() -> "ComputeAxes | None":
    """The rank's groups while a partitioned step runs, else None."""
    return _ctx.compute if _ctx.on else None


@contextlib.contextmanager
def active(mesh, compute: ComputeAxes, *, zero3: bool = False):
    """``activate(mesh, compute=compute)`` for the block; the previous
    record (or none) is restored after it."""
    saved = dict(vars(_ctx))
    activate(mesh, zero3=zero3, compute=compute)
    try:
        yield compute
    finally:
        vars(_ctx).clear()
        vars(_ctx).update(saved)


def shard(x, *roles):
    """``x``, unchanged: one role ("dp" | "model" | None) a dimension."""
    if not _ctx.on:
        return x
    assert len(roles) == x.ndim, (roles, tuple(x.shape))
    for role in roles:
        if role not in ("dp", "model", None):
            raise ValueError(f"unknown sharding role {role!r}")
    return x
