"""Time launch variants of the camera node's knob kernel on one card.

    python3 scripts/knobs_variants.py

Each variant is the shipped ``src/repro_torch/kernels/csrc/frame_knobs.cu``
with one or two of its launch constants rewritten (the output tile, the
grid's order, the units a thread loads before using one), built with
``nvcc`` and the port's flags into ``build/knobs_variants/``, all builds
started together.  At 1080x1920 it runs every variant and the shipped
kernel (the port's wrapper) on the inputs ``chip_smoke.py``'s
frame_knobs_kernel phase times -- 25 independent uint8 and float32 frame
pairs at blur 5 and 15, and the camera path's overlapping float32 window
``g[1:]``/``g[:-1]`` at blur 5 -- holds each result bitwise to
``frame_knobs_plain`` and times it behind the spin kernel
(``chip_smoke.device_ms``).  Prints the card's ``name, power.limit``, one
JSON line per (variant, case), and the card's line again.  Exits 2 without
a CUDA device; a check that fails raises.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "frame_knobs.cu"
OUT = ROOT / "build" / "knobs_variants"

TILE = "constexpr int kTileH = 30;    // output rows of one block\n" \
       "constexpr int kTileW = 120;"
BATCH = "constexpr int kBatch = 2;"
BOUNDS = ("template <typename T, bool kVec, int KT>\n__global__ void "
          "__launch_bounds__(kThreads, 4)")


def min_blocks(m: int) -> tuple[str, str]:
    return BOUNDS, BOUNDS.replace(", 4)", f", {m})")


def batch(n: int) -> tuple[str, str]:
    return BATCH, f"constexpr int kBatch = {n};"
ORDER = ("const int n = blockIdx.x, tile_x = blockIdx.y, tile_y = blockIdx.z;",
         "const dim3 grid(N, tiles_x, tiles_y);")
SLOWEST = ("const int n = blockIdx.z, tile_x = blockIdx.x, tile_y = blockIdx.y;",
           "const dim3 grid(tiles_x, tiles_y, N);")


def tile(h: int, w: int) -> tuple[str, str]:
    return TILE, (f"constexpr int kTileH = {h};    // output rows of one "
                  f"block\nconstexpr int kTileW = {w};")


# name -> text substitutions on the shipped source
VARIANTS = {
    "tile_60x120_min_blocks_1_batch_4": [tile(60, 120), min_blocks(1),
                                         batch(4)],
    "frame_slowest": list(zip(ORDER, SLOWEST)),
    "tile_36x120": [tile(36, 120)],
    "tile_20x120": [tile(20, 120)],
    "tile_30x240_min_blocks_3": [tile(30, 240), min_blocks(3)],
    "batch_4": [batch(4)],
    "batch_1": [batch(1)],
    "min_blocks_3": [min_blocks(3)],
}
CASES = (("uint8", "independent", 5), ("float32", "independent", 5),
         ("float32", "window", 5), ("uint8", "independent", 15),
         ("float32", "independent", 15))


def build_all() -> dict[str, ctypes.CDLL]:
    """Every variant's library, all ``nvcc`` runs started together."""
    from repro_torch.kernels import build
    text = KERNEL.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" \
        / "nvcc"
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not in the kernel")
            src = src.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [str(nvcc), *build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{out}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fk_launch.argtypes = [ptr] * 6 + [i32] * 4 + [f32] * 3 + \
            [i32, i32, ptr]
        lib.fk_launch.restype = i32
        libs[name] = lib
    return libs


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("knobs_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import frame_knobs as FK
    card = cs.card_line()
    print(card, flush=True)
    libs = build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    scratch = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    inputs = {}
    for dtype in ("uint8", "float32"):
        inputs[dtype, "independent"] = cs.knobs_inputs(
            dev, g, cs.KNOBS_N, getattr(torch, dtype))
    gray = cs.knobs_inputs(dev, g, cs.KNOBS_N + 1, torch.float32)[0]
    inputs["float32", "window"] = (gray[1:], gray[:-1])
    for dtype, case, k in CASES:
        f, p = inputs[dtype, case]
        n, h, w = f.shape
        want_out, want_ch = FK.frame_knobs_plain(f, p, blur_k=k)
        inv_hw, inv_k, delta = FK._knobs_scalars(h, w, k, 8.0)
        out = torch.empty_like(want_out)
        ch = torch.empty_like(want_ch)
        bound, _ = cs.knobs_bound_ms(f, p, k)

        def row(call, variant):
            call()
            torch.cuda.synchronize()
            got = FK.frame_knobs(f, p, blur_k=k) if variant == "shipped" \
                else (out, ch)
            if not (torch.equal(got[0], want_out)
                    and torch.equal(got[1], want_ch)):
                raise AssertionError(f"{variant} {dtype} {case} blur {k}: "
                                     f"differs from plain")
            ms, hidden = cs.device_ms(call, cs.ATTN_REPS)
            print(json.dumps(dict(variant=variant, dtype=dtype, case=case,
                                  blur_k=k, ms=ms, bound_ms=bound,
                                  hidden=hidden)), flush=True)

        row(lambda: FK.frame_knobs(f, p, blur_k=k), "shipped")
        for name, lib in libs.items():
            def call(lib=lib, name=name):
                rc = lib.fk_launch(f.data_ptr(), p.data_ptr(), out.data_ptr(),
                                   ch.data_ptr(), scratch[0].data_ptr(),
                                   scratch[1].data_ptr(), n, h, w, k, inv_k,
                                   inv_hw, delta,
                                   FK.KNOBS_KERNEL_DTYPES[f.dtype], 1, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            row(call, name)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
