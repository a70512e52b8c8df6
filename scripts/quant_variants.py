"""Time the quantize pair's launch variants on one card.

    python3 scripts/quant_variants.py

Builds ``scripts/quant_variants.cu`` with ``nvcc`` (the port's flags) into
``build/quant_variants/``.  On the largest gradient leaf of the full-width
``qwen3-1.7b`` step (``[688128, 512]``, float32, bits 8: the input
``chip_smoke.py``'s quant_kernels phase times) it then runs every variant
of ``QUANT_VARIANTS`` and ``DEQ_VARIANTS``, holds each output bitwise to the
plain version, and times it behind the spin kernel (``chip_smoke.
device_ms``) beside the shipped kernels (the port's wrappers) and the
write-only ceiling (``zero_`` of the float32 output).  Prints the card's
``name, power.limit``, one JSON line per row with its ms and GB/s of the
bound's bytes, and the card's line again.  Exits 2 without a CUDA device;
any check that fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().with_suffix(".cu")

# quantize: (persistent clusters, an L2 prefetch of each CTA's share of the
# next tile).  dequantize: bytes of q a chunk (4: one float4 store a lane;
# 16: four), chunks a thread loads before it stores, streaming stores, and
# the grid and order ("card": SMs x resident blocks on one grid-stride
# front; "per_tile": 512 threads a tile on that front; "warp_walk": the
# same threads, each warp walking 1/16 of a tile alone)
QUANT_VARIANTS = ((1, 0), (1, 1), (0, 0), (0, 1))
DEQ_VARIANTS = tuple((qb, unroll, streaming, grid)
                     for grid in ("card", "per_tile", "warp_walk")
                     for qb in (16, 4) for unroll in (4, 1)
                     for streaming in (0, 1))


def build_library() -> ctypes.CDLL:
    """``quant_variants.cu`` built (or loaded from the cache) and bound."""
    from repro_torch.kernels import build
    key = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode()
                         + SOURCE.read_bytes()).hexdigest()[:16]
    out = ROOT / "build" / "quant_variants" / f"quant_variants-{key}.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        nvcc = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") \
            / "bin" / "nvcc"
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        done = subprocess.run([str(nvcc), *build.NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        Path(str(out) + ".log").write_text(done.stdout + done.stderr)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc exited {done.returncode}:\n"
                               f"{done.stdout}{done.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.quantize_variant_launch.argtypes = [ptr, ptr, ptr, *[i32] * 4,
                                            ctypes.c_float, i32, i32, ptr]
    lib.dequantize_variant_launch.argtypes = [ptr, ptr, ptr, *[i32] * 8,
                                              ctypes.c_longlong, ptr]
    lib.quantize_variant_launch.restype = i32
    lib.dequantize_variant_launch.restype = i32
    lib.variant_error_string.argtypes = [i32]
    lib.variant_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("quant_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import quantize as Q
    card = cs.card_line()
    print(card, flush=True)
    lib = build_library()
    dev = torch.device("cuda")
    _, shape, _ = max(cs.grad_leaves(get_config(cs.TRAIN_ARCH)),
                      key=lambda leaf: leaf[2])
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = cs.quant_input(dev, g, *shape, torch.float32)
    qp, sp = Q.quantize_blocks_plain(x, block=cs.QUANT_BLOCK)
    want = Q.dequantize_blocks_plain(qp, sp, block=cs.QUANT_BLOCK)
    q, s, out = torch.empty_like(qp), torch.empty_like(sp), \
        torch.empty_like(want)
    m, n = shape
    bm, bn = cs.QUANT_BLOCK
    qmax = Q.QMAX[8]
    tiles = sp.numel()
    bound, _ = cs.quant_bound_ms(torch.float32, m, n)
    nbytes = bound * cs.HBM_BYTES_PER_S / 1e3
    stream = torch.cuda.current_stream().cuda_stream

    def run(rc):
        if rc:
            raise RuntimeError(f"CUDA error {rc}: "
                               f"{lib.variant_error_string(rc).decode()}")

    def row(call, check, **knobs):
        call()
        torch.cuda.synchronize()
        if not check():
            raise AssertionError(f"{knobs}: differs from plain")
        ms, hidden = cs.device_ms(call, cs.ATTN_REPS)
        print(json.dumps(dict(**knobs, ms=ms, gbps=nbytes / ms / 1e6,
                              hidden=hidden)), flush=True)

    print(json.dumps(dict(shape=list(shape), bound_ms=bound)), flush=True)
    row(lambda: Q.quantize_blocks(x, block=cs.QUANT_BLOCK),
        lambda: all(map(torch.equal, Q.quantize_blocks(
            x, block=cs.QUANT_BLOCK), (qp, sp))),
        kernel="quantize", variant="shipped")
    for persistent, prefetch in QUANT_VARIANTS:
        q.zero_()
        row(lambda: run(lib.quantize_variant_launch(
                x.data_ptr(), q.data_ptr(), s.data_ptr(), m, n, bm, bn, qmax,
                persistent, prefetch, stream)),
            lambda: torch.equal(q, qp) and torch.equal(s, sp),
            kernel="quantize", persistent=persistent, prefetch=prefetch)
    row(lambda: Q.dequantize_blocks(qp, sp, block=cs.QUANT_BLOCK),
        lambda: torch.equal(Q.dequantize_blocks(qp, sp, block=cs.QUANT_BLOCK),
                            want),
        kernel="dequantize", variant="shipped")
    for qb, unroll, streaming, grid in DEQ_VARIANTS:
        blocks = 0 if grid == "card" else 2 * tiles
        span = bm * bn // qb // 16 if grid == "warp_walk" else 0
        out.zero_()
        row(lambda: run(lib.dequantize_variant_launch(
                qp.data_ptr(), sp.data_ptr(), out.data_ptr(), m, n, bm, bn,
                qb, unroll, streaming, blocks, span, stream)),
            lambda: torch.equal(out, want), kernel="dequantize", qb=qb,
            unroll=unroll, streaming=streaming, grid=grid)
    ms, hidden = cs.device_ms(out.zero_, cs.ATTN_REPS)
    print(json.dumps(dict(kernel="write_only", call="zero_", ms=ms,
                          gbps=out.numel() * 4 / ms / 1e6, hidden=hidden)),
          flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
