"""Approximate collectives: Algorithm 1 pointed at the gradient link.

The port of the JAX package's ``core/approx_comm.py``.  The paper trades
video-frame fidelity for wireless latency under an accuracy floor; here
the contended link is the gradient reduction between data-parallel
replicas, and the same control law picks its payload:

  payload knob     gradient quantization level: bf16 -> int8 -> int4-range
                   (``repro_torch.kernels.quantize``, per-block scales)
  latency sensor   measured collective time per step
  regression       latency ~= slope * payload_bytes + intercept
  accuracy floor   gradient fidelity = cosine similarity between the
                   round-tripped gradient and the exact one, characterized
                   offline per level (``characterize_fidelity``)
  controller       the port's ``fleet_controller_step`` (one lane) picks the
                   level each step (``CollectiveController``)

The collective (``compressed_mean``) runs over ``torch.distributed``: each
member quantizes its tensor, all-gathers the int8 payload and the float32
block scales, and dequantizes and averages every member's share locally
in rank order.  ``make_grad_compressor`` returns the hook that
``launch.steps.build_train_step`` applies to every gradient before AdamW:
the numerics of compressed transport on one replica.

Routing: on a CUDA tensor the quantize round trip runs the hand-written
kernels (``quantize_blocks`` / ``dequantize_blocks``), on a CPU tensor
their plain versions.  The JAX package's own round trip calls the oracles
``repro.kernels.ref.quantize_ref`` / ``dequantize_ref``, never its Pallas
kernels; the plain versions equal those oracles bit for bit, and the
kernels equal the plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.characterization import (CharacterizationTable,
                                               LatencyRegression)
from repro_torch.core.controller import (ControllerConfig, ControllerParams,
                                         ControllerTables, LatencyController,
                                         fleet_controller_init,
                                         fleet_controller_step, stack_params,
                                         stack_tables)
from repro_torch.core.knobs import KnobSetting
from repro_torch.device import resolve_device
from repro_torch.kernels import quantize as Q
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["CompressionLevel", "LEVELS", "compressed_mean",
           "make_grad_compressor", "characterize_fidelity",
           "collective_bytes_for", "fidelity_table", "CollectiveController",
           "CollectiveDecision"]


@dataclasses.dataclass(frozen=True)
class CompressionLevel:
    name: str
    bits: int            # 16 = no compression, 8, 4
    wire_factor: float   # payload bytes / bf16 bytes


LEVELS = (
    CompressionLevel("bf16", 16, 1.0),
    CompressionLevel("int8", 8, 0.5 + 1 / 256),     # + per-block scales
    CompressionLevel("int4", 4, 0.25 + 1 / 256),
)


def _pad_2d(x: torch.Tensor, block=(256, 512)) -> tuple[torch.Tensor, int]:
    """``x`` flattened, zero-padded to a whole number of ``bm * bn`` tiles
    and viewed as ``[rows, bn]``; returns it and ``x``'s element count.  A
    contiguous ``x`` that needs no padding comes back as a view (no
    copy)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % (block[0] * block[1])
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, block[1]), n


def _quant_roundtrip(x: torch.Tensor, bits: int, block=(256, 512)
                     ) -> torch.Tensor:
    """Quantize-dequantize a tensor (the numerical effect of transport), in
    ``x``'s shape and dtype; ``bits >= 16`` returns ``x`` itself.  The
    kernels run on a CUDA tensor, the plain versions on a CPU tensor (the
    wrappers' routes).  A float32 or bfloat16 ``x`` is dequantized straight
    into its own type: one rounding of the float32 product, the bits of the
    JAX package's float32 result cast back."""
    if bits >= 16:
        return x
    x2d, n = _pad_2d(x, block)
    out_dtype = x.dtype if x.dtype in Q.KERNEL_DTYPES else torch.float32
    q, s = Q.quantize_blocks(x2d, block=block, bits=bits)
    xd = Q.dequantize_blocks(q, s, block=block, out_dtype=out_dtype)
    return xd.reshape(-1)[:n].view(x.shape).to(x.dtype)


def compressed_mean(x: torch.Tensor, bits: int, *, group=None,
                    block=(256, 512)) -> torch.Tensor:
    """Mean of ``x`` over the members of ``group`` (the default process
    group when None) with quantized transport: all-gather every member's
    int8 payload and block scales, dequantize each share and sum them in
    rank order, divide by the group's size.  ``bits >= 16`` is the exact
    mean (``all_reduce`` sum over the size).  Returns a new tensor in
    ``x``'s shape and dtype; every member gets the same result."""
    world = dist.get_world_size(group)
    if bits >= 16:
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / world
    x2d, n = _pad_2d(x, block)
    q, s = Q.quantize_blocks(x2d, block=block, bits=bits)
    qg = q.new_empty((world * q.shape[0], q.shape[1]))
    sg = s.new_empty((world * s.shape[0], s.shape[1]))
    dist.all_gather_into_tensor(qg, q.contiguous(), group=group)
    dist.all_gather_into_tensor(sg, s.contiguous(), group=group)
    total = None
    for qi, si in zip(qg.chunk(world), sg.chunk(world)):
        xi = Q.dequantize_blocks(qi, si, block=block)
        total = xi if total is None else total.add_(xi)
    mean = total / world
    return mean.reshape(-1)[:n].view(x.shape).to(x.dtype)


def make_grad_compressor(bits: int, *, block=(256, 512),
                         min_size: int = 65536) -> Callable:
    """Hook for ``build_train_step``: the quantize round trip on every
    gradient leaf of at least ``min_size`` elements (smaller leaves pass
    through); ``bits >= 16`` returns the gradients as they are."""
    def hook(grads):
        if bits >= 16:
            return grads
        return tree_map(lambda g: _quant_roundtrip(g, bits, block)
                        if g.numel() >= min_size else g, grads)
    return hook


def collective_bytes_for(grad_bytes_bf16: float, bits: int) -> float:
    lvl = {l.bits: l for l in LEVELS}[bits]
    return grad_bytes_bf16 * lvl.wire_factor


def fidelity_table(grad_bytes_bf16: float, fidelity: dict[int, float]
                   ) -> CharacterizationTable:
    """The Algorithm-1 tables for the gradient link: "size" = wire bytes
    per compression level, "accuracy" = gradient cosine fidelity (the F1
    analogue).  Returns a ``CharacterizationTable`` for either the host
    ``LatencyController`` or the device fleet step."""
    sizes = np.asarray([collective_bytes_for(grad_bytes_bf16, lvl.bits)
                        for lvl in LEVELS], np.float64)
    accs = np.asarray([fidelity[lvl.bits] for lvl in LEVELS], np.float64)
    order = np.argsort(sizes, kind="stable")
    best_acc, best_idx, run = [], [], (-1.0, -1)
    for i in order:
        if accs[i] > run[0]:
            run = (float(accs[i]), int(i))
        best_acc.append(run[0])
        best_idx.append(run[1])
    return CharacterizationTable(
        settings=tuple(KnobSetting() for _ in LEVELS),
        sizes_sorted=sizes[order], best_acc=np.asarray(best_acc),
        best_idx=np.asarray(best_idx), acc_by_setting=accs,
        size_by_setting=sizes, min_accuracy=0.0, source="approx-comm")


@dataclasses.dataclass(frozen=True)
class CollectiveDecision:
    """One reduction's transport decision."""
    bits: int                # compression level to use for the NEXT step
    setting_index: int       # row of the fidelity table (-1 = none)
    feasible: bool           # fidelity floor met within the latency budget
    acted: bool              # outside the error band this step


class CollectiveController:
    """Algorithm 1 picking the gradient compression level on the device
    fleet step: a one-lane fleet whose fidelity table becomes padded
    ``ControllerTables``, whose law constants become a stacked
    ``ControllerParams`` row (gains precomputed in float64 by a host
    ``LatencyController`` twin, which also seeds the operating point), and
    which steps ``fleet_controller_step`` -- the camera fleet's own step --
    once per reduction.  Its decisions equal a host ``LatencyController``'s
    with the same config.

    ``device`` (default ``"cuda"``) holds the tables and the state; each
    ``update`` reads its decision back to the host."""

    def __init__(self, grad_bytes_bf16: float, fidelity: dict[int, float],
                 *, latency_target: float, fidelity_floor: float = 0.98,
                 slope: float, intercept: float = 1e-4,
                 error_threshold: float | None = None,
                 capacity: int | None = None,
                 device: "str | torch.device | None" = None):
        dev = resolve_device(device)
        self.table = fidelity_table(grad_bytes_bf16, fidelity)
        if error_threshold is None:
            error_threshold = 0.05 * latency_target
        cfg = ControllerConfig(latency_target=latency_target,
                               accuracy_target=fidelity_floor,
                               error_threshold=error_threshold)
        reg = LatencyRegression(slope=slope, intercept=intercept)
        self._host = LatencyController(cfg, self.table, reg)
        cap = capacity or max(8, len(LEVELS))
        self.tables = stack_tables([ControllerTables.from_table(
            self.table, capacity=cap, device=dev)])
        self.params = stack_params([ControllerParams.from_controller(
            self._host, device=dev)])
        self.state = fleet_controller_init(
            self.tables, start_idx=np.asarray([self._host._current],
                                              np.int32))
        self.bits = LEVELS[self._host._current].bits
        self._layouts: set[tuple[int, ...]] = set()

    def cache_size(self) -> int:
        """How many table layouts (lanes x capacity) the decision step
        has run on (1 = every update kept the shapes): the counterpart of
        the JAX step's compiled-variant count."""
        return len(self._layouts)

    def update(self, latency_sampled: float) -> CollectiveDecision:
        """One control tick: feed the measured reduction latency, get the
        compression level for the next step."""
        dev = self.tables.sizes_sorted.device
        self._layouts.add(tuple(self.tables.sizes_sorted.shape))
        self.state, aux = fleet_controller_step(
            self.state, torch.tensor([latency_sampled], dtype=torch.float32,
                                     device=dev), self.tables, self.params)
        idx = int(aux.idx[0])
        if idx >= 0:
            self.bits = LEVELS[idx].bits
        return CollectiveDecision(bits=self.bits, setting_index=idx,
                                  feasible=bool(aux.feasible[0]),
                                  acted=bool(aux.acted[0]))


def characterize_fidelity(grads_sample, *, block=(256, 512)
                          ) -> dict[int, float]:
    """Offline size->accuracy table (the paper's Section 2.4 analogue):
    cosine similarity between round-tripped and exact gradients, per
    level, over every leaf of ``grads_sample`` (a tensor or a dict tree)
    in the JAX package's leaf order."""
    flat = tree_leaves(grads_sample)
    vec = torch.cat([x.reshape(-1).float() for x in flat])
    out = {}
    for lvl in LEVELS:
        if lvl.bits >= 16:
            out[lvl.bits] = 1.0
            continue
        rvec = torch.cat([_quant_roundtrip(x.float(), lvl.bits, block)
                          .reshape(-1) for x in flat])
        cos = torch.dot(vec, rvec) / (
            torch.linalg.vector_norm(vec) * torch.linalg.vector_norm(rvec)
            + 1e-12)
        out[lvl.bits] = float(cos)
    return out
