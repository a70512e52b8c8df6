"""Production mesh construction, and the card's roofline constants.

The port of the JAX package's ``launch/mesh.py``.  ``make_mesh`` and
``make_production_mesh`` are functions (not module constants), so importing
this module touches no process group.  A mesh here is a
``torch.distributed`` ``DeviceMesh`` over the default process group, one
rank a card, as ``torchrun`` launches them: its size must be the group's
world size, and a missing group raises (nothing falls back to one device).
``production_mesh_shape`` is the same mesh as an ``AbstractMesh`` (sizes
and names, no devices), for code that needs only the specs, and
``fake_mesh`` / ``fake_production_mesh`` the counterpart of the JAX
dry-run's 512 host devices: a ``DeviceMesh`` of the production shape over
a fake process group of 256 or 512 ranks in the calling process, on which
a rank's step runs its collectives on meta tensors (nothing is sent) so
that ``meta.MetaPass`` can count them; it is torn down when the block
ends (a default group left behind would leak into everything the process
runs next).

Production topology: 16 x 16 = 256 cards a pod (``("data", "model")``);
multi-pod adds a leading ``"pod"`` axis (2 pods = 512 cards).  The pod
axis composes with ``data`` for DP/FSDP; ``model`` is the TP/SP axis.

``HardwareSpec`` holds the rates the dry-run and the kernel bounds read,
and ``H100`` is the NVIDIA H100 SXM's (NVIDIA's data sheet, dense rates
at the 700 W power limit).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

from repro_torch.sharding.partition import AbstractMesh

__all__ = ["HardwareSpec", "H100", "make_mesh", "make_production_mesh",
           "production_mesh_shape", "fake_mesh", "fake_production_mesh"]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants of one card."""
    name: str
    peak_flops_bf16: float     # FLOP/s, dense tensor cores
    hbm_bandwidth: float       # bytes/s
    hbm_bytes: float


H100 = HardwareSpec(
    name="NVIDIA H100 80GB HBM3",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    hbm_bytes=80e9,
)


def _production(multi_pod: bool) -> tuple[tuple, tuple]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def production_mesh_shape(multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's sizes and names, with no devices."""
    return AbstractMesh(*_production(multi_pod))


def make_mesh(shape: tuple, axes: tuple, *,
              device_type: "str | None" = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group (``device_type`` default ``"cuda"``; the CPU tests pass
    ``"cpu"`` over a gloo group).  Raises ``RuntimeError`` when no group
    is initialised and ``ValueError`` when ``prod(shape)`` is not the
    world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} against axes {axes}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no process group is initialised "
                           "(launch one process a rank, e.g. with "
                           "torchrun, and call init_process_group)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} has {math.prod(shape)} ranks, the "
                         f"process group {world}")
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: "str | None" = None):
    """``make_mesh`` at ``(16, 16)`` / ``("data", "model")``, or at
    ``(2, 16, 16)`` / ``("pod", "data", "model")`` with ``multi_pod``."""
    shape, axes = _production(multi_pod)
    return make_mesh(shape, axes, device_type=device_type)


@contextlib.contextmanager
def fake_mesh(shape: tuple, axes: tuple, *, rank: int = 0):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a ``"fake"``
    process group of ``prod(shape)`` ranks in this process, as rank
    ``rank``: its collectives return tensors of the right shapes and send
    nothing (on meta tensors, nothing is computed either).  The group is
    destroyed when the block ends; an initialised group already in place
    raises ``RuntimeError``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape),
                               mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()


def fake_production_mesh(*, multi_pod: bool = False, rank: int = 0):
    """``fake_mesh`` of the production shape: ``(16, 16)`` /
    ``("data", "model")``, or ``(2, 16, 16)`` / ``("pod", "data",
    "model")`` with ``multi_pod``."""
    return fake_mesh(*_production(multi_pod), rank=rank)
