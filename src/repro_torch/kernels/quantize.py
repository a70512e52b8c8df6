"""Symmetric per-block quantization (the approximate collective's payload):
the hand-written CUDA kernels and their plain PyTorch versions.

Port of the JAX package's ``kernels/quantize.py`` (the Pallas TPU kernels
``quantize_blocks`` and ``dequantize_blocks``).  Each (bm, bn) tile of an
``[M, N]`` tensor gets one float32 scale::

    scale = max(absmax(tile) / qmax, 1e-12)
    q     = clip(round(x / scale), -qmax, qmax)  as int8
    x'    = q * scale                           in the output type

with qmax 127 (``bits=8``) or 7 (``bits=4``: the int4 range, one int8 per
value; transport would pack two per byte).  The tile is ``(min(bm, M),
min(bn, N))``, which must divide ``[M, N]``, as in the JAX package.

Three pieces per direction:

``quantize_blocks_plain``    plain PyTorch ops on the block view, in the op
``dequantize_blocks_plain``  order of the JAX oracle ``repro.kernels.ref::
                             quantize_ref`` / ``dequantize_ref`` (bit for
                             bit on finite inputs).  The CPU route and the
                             card's yardstick.
``quantize_blocks``          the wrappers: a CUDA tensor launches the
``dequantize_blocks``        kernel of ``csrc/quantize_blocks.cu`` (counted
                             in ``.launches`` and per route in
                             ``.launches_by_route``), a CPU tensor takes
                             the plain version, anything else raises.  No
                             ``try`` falls back: a failed build or launch
                             raises.
``route_for``                the route of a CUDA call, from the shape and
                             tile alone: "contiguous" where the tile spans
                             whole rows (N == bn: each tile one span of
                             memory, as on every call of the approximate
                             collective), "strided" otherwise.  Both routes
                             are the same kernels (quantize: one cluster of
                             CTAs per tile, each tile read once; dequantize:
                             one flat stream sized to the card); they
                             differ in how an element's offset is found.

The plain version divides by tensors, never by a Python number: on a CUDA
tensor PyTorch turns a division by a host scalar into a multiplication by
its reciprocal, which can land one float32 ulp away from the kernel's (and
the oracle's) IEEE division.  It builds those tensors on the device
(``full_like``): a tensor made from a host number is a copy that waits
for the stream's queued work.  The contract covers finite inputs; a NaN or
an infinity in a tile makes the two routes disagree on that tile.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["quantize_blocks", "dequantize_blocks", "quantize_blocks_plain",
           "dequantize_blocks_plain", "tile_shape", "route_for", "ROUTES",
           "QMAX", "KERNEL_DTYPES", "SCALE_FLOOR"]

QMAX = {8: 127.0, 4: 7.0}
SCALE_FLOOR = 1e-12
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("contiguous", "strided")

_lib = None


def _load_lib():
    """The built kernel library (compiled at first use, never at import)."""
    global _lib
    if _lib is None:
        from repro_torch.kernels import build
        lib = build.load_library("quantize_blocks")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.quantize_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                        ctypes.c_float, i32, ptr]
        lib.quantize_launch.restype = i32
        lib.dequantize_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                          i32, ptr]
        lib.dequantize_launch.restype = i32
        lib.quantize_error_string.argtypes = [i32]
        lib.quantize_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def tile_shape(shape, block=(256, 512)) -> tuple[int, int]:
    """The tile ``(min(bm, M), min(bn, N))`` of a 2-D ``shape``; raises
    ``ValueError`` unless it divides the shape (the JAX kernel asserts it:
    callers pad)."""
    if len(shape) != 2:
        raise ValueError(f"quantize: a 2-D tensor expected, got shape "
                         f"{tuple(shape)}")
    m, n = shape
    bm, bn = min(block[0], m), min(block[1], n)
    if bm < 1 or bn < 1 or m % bm or n % bn:
        raise ValueError(f"quantize: tile {(bm, bn)} does not divide shape "
                         f"{(m, n)}")
    return bm, bn


def route_for(shape, block=(256, 512)) -> str:
    """The kernel route a CUDA call on a 2-D ``shape`` takes: "contiguous"
    where the tile ``tile_shape(shape, block)`` spans whole rows, so that
    each tile is one span of memory, else "strided".  Raises
    ``ValueError`` as ``tile_shape`` does."""
    _, bn = tile_shape(shape, block)
    return "contiguous" if bn == shape[1] else "strided"


def _qmax(bits: int) -> float:
    if bits not in QMAX:
        raise ValueError(f"quantize: bits must be one of {sorted(QMAX)}, "
                         f"got {bits}")
    return QMAX[bits]


def quantize_blocks_plain(x: torch.Tensor, *, block=(256, 512),
                          bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[M, N]`` (any float type) -> (q int8 ``[M, N]``, scales float32
    ``[M/bm, N/bn]``), as ``quantize_ref``: the block view in float32, the
    absmax per tile, the floored scale, round half to even, clip."""
    m, n = x.shape
    bm, bn = tile_shape(x.shape, block)
    qmax = _qmax(bits)
    xb = x.float().reshape(m // bm, bm, n // bn, bn).transpose(1, 2)
    absmax = xb.abs().amax(dim=(-1, -2))
    scales = (absmax / torch.full_like(absmax, qmax)).clamp_min(SCALE_FLOOR)
    q = torch.round(xb / scales[..., None, None]).clamp_(-qmax, qmax)
    return q.transpose(1, 2).reshape(m, n).to(torch.int8), scales


def dequantize_blocks_plain(q: torch.Tensor, scales: torch.Tensor, *,
                            block=(256, 512),
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """q int8 ``[M, N]`` and float32 scales ``[M/bm, N/bn]`` -> ``q *
    scale`` in float32, cast to ``out_dtype`` (as ``dequantize_ref``)."""
    m, n = q.shape
    bm, bn = tile_shape(q.shape, block)
    _check_scales(q, scales, bm, bn)
    qb = q.float().reshape(m // bm, bm, n // bn, bn).transpose(1, 2)
    xb = qb * scales.float()[..., None, None]
    return xb.transpose(1, 2).reshape(m, n).to(out_dtype)


def _check_scales(q, scales, bm, bn) -> None:
    want = (q.shape[0] // bm, q.shape[1] // bn)
    if tuple(scales.shape) != want:
        raise ValueError(f"dequantize: scales {want} expected for q "
                         f"{tuple(q.shape)} in tiles {(bm, bn)}, got "
                         f"{tuple(scales.shape)}")


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    if any(t.device.type != "cuda" for t in tensors) \
            or len({t.device for t in tensors}) != 1:
        raise RuntimeError(f"{name}: every tensor on one CUDA device (or "
                           f"all on the CPU) expected, got "
                           f"{sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise RuntimeError(f"{name}: the kernel takes contiguous tensors")


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{lib.quantize_error_string(rc).decode()}")


def quantize_blocks(x: torch.Tensor, *, block=(256, 512), bits: int = 8
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[M, N]`` -> (q int8 ``[M, N]``, scales float32 ``[M/bm,
    N/bn]``).  On a CUDA tensor (float32 or bfloat16, contiguous) the
    kernel runs and adds one to ``quantize_blocks.launches`` and to the
    entry of ``route_for(x.shape, block)`` in
    ``quantize_blocks.launches_by_route``; on a CPU
    tensor ``quantize_blocks_plain`` runs; anything else raises
    ``RuntimeError``.  A tile that does not divide the shape raises
    ``ValueError``."""
    qmax = _qmax(bits)
    bm, bn = tile_shape(x.shape, block)
    if x.device.type == "cpu":
        return quantize_blocks_plain(x, block=block, bits=bits)
    _check_cuda("quantize_blocks", x)
    if x.dtype not in KERNEL_DTYPES:
        raise RuntimeError(f"quantize_blocks: the kernel takes float32 or "
                           f"bfloat16, got {x.dtype}")
    m, n = x.shape
    lib = _load_lib()
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    scales = torch.empty((m // bm, n // bn), dtype=torch.float32,
                         device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quantize_launch(x.data_ptr(), q.data_ptr(),
                                 scales.data_ptr(), m, n, bm, bn, qmax,
                                 KERNEL_DTYPES[x.dtype], stream)
    _raise_on(lib, rc, "quantize_blocks")
    quantize_blocks.launches += 1
    quantize_blocks.launches_by_route[route_for(x.shape, block)] += 1
    return q, scales


quantize_blocks.launches = 0
quantize_blocks.launches_by_route = dict.fromkeys(ROUTES, 0)


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor, *,
                      block=(256, 512),
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """q int8 ``[M, N]`` and float32 scales -> ``q * scale`` as
    ``out_dtype``.  On CUDA tensors (out_dtype float32 or bfloat16) the
    kernel runs and adds one to ``dequantize_blocks.launches`` and to its
    route's entry of ``dequantize_blocks.launches_by_route``; on CPU
    tensors ``dequantize_blocks_plain`` runs; anything else raises
    ``RuntimeError``."""
    bm, bn = tile_shape(q.shape, block)
    _check_scales(q, scales, bm, bn)
    if q.device.type == "cpu" and scales.device.type == "cpu":
        return dequantize_blocks_plain(q, scales, block=block,
                                       out_dtype=out_dtype)
    _check_cuda("dequantize_blocks", q, scales)
    if q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or out_dtype not in KERNEL_DTYPES:
        raise RuntimeError(f"dequantize_blocks: the kernel takes int8 q, "
                           f"float32 scales and a float32 or bfloat16 "
                           f"output, got {q.dtype}, {scales.dtype}, "
                           f"{out_dtype}")
    m, n = q.shape
    lib = _load_lib()
    out = torch.empty((m, n), dtype=out_dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dequantize_launch(q.data_ptr(), scales.data_ptr(),
                                   out.data_ptr(), m, n, bm, bn,
                                   KERNEL_DTYPES[out_dtype], stream)
    _raise_on(lib, rc, "dequantize_blocks")
    dequantize_blocks.launches += 1
    dequantize_blocks.launches_by_route[route_for(q.shape, block)] += 1
    return out


dequantize_blocks.launches = 0
dequantize_blocks.launches_by_route = dict.fromkeys(ROUTES, 0)
