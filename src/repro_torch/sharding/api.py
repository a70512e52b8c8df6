"""Activation sharding roles, mesh-agnostic.

The port of the JAX package's ``sharding/api.py``.  There, model code calls
``shard(x, "dp", None, "model")`` at key activation points and, under an
activated mesh, that lowers to a ``with_sharding_constraint``.  The port
trains SPMD the torch way (``launch/train.py``): each rank computes on
whole (gathered) parameters and its own batch rows, so no activation has
a layout to pin, and ``shard`` checks that it got one role a dimension,
as JAX's assert does, and returns ``x`` unchanged.  The models do not
call it.  ``activate`` / ``active_axes`` keep JAX's record of the mesh's
DP and model axes.  No code of the port reads that record yet: it is
there for tensor-parallel compute, whose layers will read the model
axis from it (ROADMAP Queue 1 item 4, the third step left).

Roles per dim: "dp" (pod+data, all three axes under zero3), "model", None.
"""

from __future__ import annotations

import threading

from repro_torch.sharding.partition import mesh_axes

__all__ = ["activate", "deactivate", "shard", "active_axes"]

_ctx = threading.local()


def activate(mesh, *, zero3: bool = False) -> None:
    """Record ``mesh``'s axes (an ``AbstractMesh`` or a ``DeviceMesh``)
    for this thread."""
    mesh = mesh_axes(mesh)
    names = ("pod", "data", "model") if zero3 else ("pod", "data")
    _ctx.dp = tuple(n for n in names if n in mesh.axis_names)
    # under zero3 the model axis is free for sequence sharding
    _ctx.model = "model" if "model" in mesh.axis_names else None
    _ctx.sizes = dict(mesh.shape)
    _ctx.mesh = mesh
    _ctx.on = True


def deactivate() -> None:
    _ctx.on = False


def active_axes() -> dict | None:
    """``{"dp", "model", "sizes"}`` of the activated mesh, else None."""
    if not getattr(_ctx, "on", False):
        return None
    return {"dp": _ctx.dp, "model": _ctx.model, "sizes": _ctx.sizes}


def shard(x, *roles):
    """``x``, unchanged: one role ("dp" | "model" | None) a dimension."""
    if not getattr(_ctx, "on", False):
        return x
    assert len(roles) == x.ndim, (roles, tuple(x.shape))
    for role in roles:
        if role not in ("dp", "model", None):
            raise ValueError(f"unknown sharding role {role!r}")
    return x
