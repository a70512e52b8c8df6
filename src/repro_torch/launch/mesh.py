"""The card's roofline constants.

The port of the JAX package's ``launch/mesh.py`` for one card:
``HardwareSpec`` holds the rates the dry-run and the kernel bounds read,
and ``H100`` is the NVIDIA H100 SXM's (NVIDIA's data sheet, dense rates
at the 700 W power limit).  ``make_production_mesh`` and ``make_mesh``
(a device mesh over many cards) come with ROADMAP Queue 1, fleet mesh and
sharding.
"""

from __future__ import annotations

import dataclasses

__all__ = ["HardwareSpec", "H100"]


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
