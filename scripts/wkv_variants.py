"""Time the wkv scan's launch variants on one card.

    python3 scripts/wkv_variants.py

Builds ``scripts/wkv_variants.cu`` (the port's own kernel template at other
launch constants) with ``nvcc`` and the port's flags into
``build/wkv_variants/``.  At the serving shapes of ``rwkv6-1.6b`` that
``chip_smoke.py``'s rwkv_kernels phase times -- prefill B=8 S=1024 H=32 K=64
in bfloat16 and float32, and a decode step B=8 S=1 in bfloat16, each from a
random state -- it runs every variant the library lists, holds its y and
state to ``wkv_plain`` within ``chip_smoke.WKV_TOL``, and times it behind
the spin kernel (``chip_smoke.device_ms``) beside the shipped kernel (the
port's wrapper); at the decode step also an empty launch and a ``copy_`` of
the state, the floors that step sits on.  Prints the card's ``name,
power.limit``, one JSON line per (variant, case) with its registers and
spills from ``-Xptxas -v``, and the card's line again.  Exits 2 without a
CUDA device; a check that fails raises."""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().with_suffix(".cu")
KERNEL = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / \
    "wkv_linear_scan.cu"
# (B, S, dtype): the serve's prefill in both types, one decode step
CASES = ((8, 1024, "bfloat16"), (8, 1024, "float32"), (8, 1, "bfloat16"))


def build_library() -> tuple[ctypes.CDLL, str]:
    """``wkv_variants.cu`` built (or loaded from the cache) and bound, with
    its ``-Xptxas -v`` report."""
    from repro_torch.kernels import build
    key = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode()
                         + SOURCE.read_bytes() + KERNEL.read_bytes()
                         ).hexdigest()[:16]
    out = ROOT / "build" / "wkv_variants" / f"wkv_variants-{key}.so"
    log = Path(str(out) + ".log")
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        nvcc = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") \
            / "bin" / "nvcc"
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        done = subprocess.run([str(nvcc), *build.NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        log.write_text(done.stdout + done.stderr)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc exited {done.returncode}:\n"
                               f"{done.stdout}{done.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wkv_variant_launch.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
    lib.wkv_variant_launch.restype = i32
    lib.wkv_variant_list.restype = ctypes.c_char_p
    lib.wkv_error_string.argtypes = [i32]
    lib.wkv_error_string.restype = ctypes.c_char_p
    return lib, log.read_text()


def ptxas(log: str, variant: tuple[int, ...], dtype: str) -> dict:
    """Registers and spill bytes of the kernel instantiated for
    ``variant`` in ``dtype`` (mangled ``Li64ELiKQELiNVELiVSELiTCE``)."""
    tname = "f" if dtype == "float32" else "13__nv_bfloat16"
    tag = "wkv_chunk_scanI" + tname + "Li64E" + "".join(
        f"Li{x}E" for x in variant)
    out, cur = {}, False
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            cur = tag in m.group(1)
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                     r"bytes spill loads", ln)):
            out["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif cur and (m := re.search(r"Used (\d+) registers", ln)):
            out["registers"] = int(m.group(1))
    return out


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("wkv_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import linear_scan as LS
    card = cs.card_line()
    print(card, flush=True)
    lib, log = build_library()
    variants = [tuple(map(int, v.split()))
                for v in lib.wkv_variant_list().decode().split(";") if v]
    cfg = get_config(cs.RWKV_ARCH)
    h, kd = cfg.num_heads, cfg.head_dim
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for b, s, name in CASES:
        dtype = getattr(torch, name)
        r, k, v, lw = (torch.randn((b, s, h, kd), generator=g, device=dev)
                       for _ in range(4))
        r, k, v = r.to(dtype), k.to(dtype), v.to(dtype)
        logw = -torch.exp(lw - 1.0)
        u = torch.randn((h, kd), generator=g, device=dev)
        s0 = torch.randn((b, h, kd, kd), generator=g, device=dev)
        yw, stw = LS.wkv_plain(r, k, v, logw, u, state0=s0,
                               chunk=cs.plain_chunk(s))
        y, st = torch.empty_like(r), torch.empty_like(s0)
        bound, _ = cs.wkv_bound_ms(dtype, b, s, h, kd)

        def check(y, st, what):
            torch.cuda.synchronize()
            ey = float((y.float() - yw.float()).abs().max()
                       / yw.float().abs().max())
            es = float((st - stw).abs().max() / stw.abs().max())
            if not (ey <= cs.WKV_TOL[name] and es <= cs.WKV_TOL["state"]):
                raise AssertionError(f"{what} B={b} S={s} {name}: y {ey}, "
                                     f"state {es}")
            return ey, es

        def row(call, **extra):
            ms, hidden = cs.device_ms(call, cs.ATTN_REPS)
            print(json.dumps(dict(b=b, s=s, dtype=name, **extra, ms=ms,
                                  bound_ms=bound, hidden=hidden)),
                  flush=True)

        ey, es = check(*LS.wkv_linear_scan(r, k, v, logw, u, state0=s0),
                       "shipped")
        row(lambda: LS.wkv_linear_scan(r, k, v, logw, u, state0=s0),
            variant="shipped", y_err=ey, state_err=es)
        for var in variants:
            def call(var=var):
                rc = lib.wkv_variant_launch(
                    r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                    u.data_ptr(), s0.data_ptr(), y.data_ptr(), st.data_ptr(),
                    b, s, h, 0 if name == "float32" else 1, *var, stream)
                if rc:
                    raise RuntimeError(f"{var}: CUDA error {rc}: "
                                       f"{lib.wkv_error_string(rc).decode()}")
            call()
            ey, es = check(y, st, str(var))
            row(call, variant=dict(zip(("KQ", "NV", "VS", "TC"),
                                                 var)),
                y_err=ey, state_err=es, **ptxas(log, var, name))
        if s == 1:
            # the floors a decode step sits on: one launch that does
            # nothing, and a plain copy of the state it reads and writes
            row(lambda: torch.cuda._sleep(0), variant="empty launch")
            row(lambda: st.copy_(s0), variant="state copy_")
        del r, k, v, lw, logw, u, s0, yw, stw, y, st
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
