"""Blockwise (flash) GQA attention: the hand-written CUDA kernel and its
plain PyTorch version.

Port of the JAX package's ``kernels/flash_attention.py`` (the Pallas TPU
kernel ``flash_attention``).  Two pieces:

``flash_attention_plain``   plain PyTorch ops that mirror
                            ``repro.kernels.ref.flash_attention_ref``: k/v
                            repeated over the group, f32 scores, a full
                            softmax, the result cast to ``q.dtype``.  The
                            CPU path and the card's yardstick.
``flash_attention``         the wrapper: a CUDA tensor goes to the kernel
                            route ``flash_route`` names (both hand-written,
                            in ``csrc/flash_attention.cu``), a CPU tensor
                            to the plain version, anything else raises.
``flash_route``             the route of a CUDA call, from dtype and head
                            dim alone: "wgmma" (bfloat16, D 64/112/128:
                            both products on the tensor cores, K/V tiles by
                            TMA; D 112 as a 128-wide tile whose last 16
                            columns the copies fill with zeros) or "ffma"
                            (float32, or bfloat16 at D 16/32: the f32
                            CUDA-core kernel).

Shapes follow the JAX package: q ``[B, Sq, QH, D]``, k/v ``[B, Sk, KH, D]``
with ``QH % KH == 0``; the output has q's shape and dtype.  The causal mask
is top-left aligned (``q_pos >= k_pos``), as the TPU kernel's.  The
decoder-only families' prefill is causal with ``Sq == Sk``; the enc-dec
family also runs full (``causal=False``) attention, over ``Sq == Sk`` in
its encoder and with ``Sq`` (decoder tokens) ``!= Sk`` (encoder frames) in
its cross-attention.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["flash_attention", "flash_attention_plain", "flash_route",
           "launch_limits", "KERNEL_DTYPES", "KERNEL_HEAD_DIMS", "ROUTES"]

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (16, 32, 64, 112, 128)
ROUTES = ("wgmma", "ffma")
WGMMA_HEAD_DIMS = (64, 112, 128)

_lib = None


def _load_lib():
    """The built kernel library (compiled at first use, never at import)."""
    global _lib
    if _lib is None:
        from repro_torch.kernels import build
        lib = build.load_library("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fa_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                  i32, i32, ctypes.c_float, i32, i32, ptr]
        lib.fa_launch.restype = i32
        lib.fa_launch_wgmma.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                        i32, i32, i32, ctypes.c_float, i32,
                                        ptr]
        lib.fa_launch_wgmma.restype = i32
        lib.fa_error_string.argtypes = [i32]
        lib.fa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _repeat_kv(x: torch.Tensor, qh: int) -> torch.Tensor:
    """``[B, S, KH, D] -> [B, S, QH, D]``: kv head ``i`` serves q heads
    ``i * group .. (i + 1) * group - 1``."""
    return x.repeat_interleave(qh // x.shape[2], dim=2)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: float | None = None) -> torch.Tensor:
    """Exact softmax attention in f32 over GQA-expanded k/v, cast to
    ``q.dtype`` (``ref.flash_attention_ref`` after a repeat of k/v)."""
    qh, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else d ** -0.5
    kx = _repeat_kv(k, qh).float()
    vx = _repeat_kv(v, qh).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vx).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise RuntimeError(f"flash_attention: q [B,Sq,QH,D], k/v [B,Sk,KH,D] "
                           f"expected, got {tuple(q.shape)}, "
                           f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, qh, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or qh % k.shape[2]:
        raise RuntimeError(f"flash_attention: q {tuple(q.shape)} and k/v "
                           f"{tuple(k.shape)} do not match (QH % KH == 0)")
    if not (q.dtype == k.dtype == v.dtype):
        raise RuntimeError(f"flash_attention: q, k, v dtypes differ "
                           f"({q.dtype}, {k.dtype}, {v.dtype})")


INT32_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65535         # CUDA's limit on a grid's y and z extents


def launch_limits(b: int, sq: int, sk: int, qh: int, kh: int, d: int,
                  route: str) -> None:
    """Raise ``RuntimeError`` for a shape the kernels cannot index.  They
    address q, k, v and the output with 64-bit offsets (a q of 2^31
    elements and more is fine), take each extent as a 32-bit int, and
    launch a grid of (QH, B, Sq / 128) blocks on ``wgmma``, (Sq / 64, QH,
    B) on ``ffma``, whose y and z extents CUDA caps at 65535."""
    dims = dict(B=b, Sq=sq, Sk=sk, QH=qh, KH=kh, D=d)
    big = {k: v for k, v in dims.items() if not 0 < v <= INT32_MAX}
    if big:
        raise RuntimeError(f"flash_attention: extents {big} outside the "
                           f"kernel's 32-bit int arguments")
    yz = ({"B": b, "Sq / 128": -(-sq // 128)} if route == "wgmma"
          else {"QH": qh, "B": b})
    over = {k: v for k, v in yz.items() if v > GRID_YZ_MAX}
    if over:
        raise RuntimeError(f"flash_attention: grid extents {over} over "
                           f"CUDA's {GRID_YZ_MAX}")


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel route a CUDA call with inputs of ``dtype`` and
    ``head_dim`` takes -- a choice by shape and type, made before any
    launch, not a fallback: "wgmma" for bfloat16 at head_dim 64, 112 or
    128 (both products on the bf16 tensor cores), "ffma" for float32 at any
    head_dim in ``KERNEL_HEAD_DIMS`` and for bfloat16 at 16 or 32 (the f32
    CUDA-core kernel, which keeps float32 out of TF32).  Anything else
    raises ``RuntimeError``."""
    if dtype not in KERNEL_DTYPES:
        raise RuntimeError(f"flash_attention: the kernel takes float32 or "
                           f"bfloat16, got {dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise RuntimeError(f"flash_attention: the kernel takes head_dim in "
                           f"{KERNEL_HEAD_DIMS}, got {head_dim}")
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "ffma"


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float) -> torch.Tensor:
    b, sq, qh, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    route = flash_route(q.dtype, d)
    launch_limits(b, sq, sk, qh, kh, d, route)
    if not (q.device == k.device == v.device):
        raise RuntimeError("flash_attention: q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise RuntimeError("flash_attention: the kernel takes contiguous "
                           "q, k, v")
    if route == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise RuntimeError("flash_attention: the wgmma route takes 16-byte "
                           "aligned q, k, v")
    lib = _load_lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                sq, sk, qh, kh, d, float(scale), int(causal))
        if route == "wgmma":
            rc = lib.fa_launch_wgmma(*args, stream)
        else:
            rc = lib.fa_launch(*args, KERNEL_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: CUDA error {rc}: "
                           f"{lib.fa_error_string(rc).decode()}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """GQA attention, q ``[B, Sq, QH, D]``, k/v ``[B, Sk, KH, D]`` ->
    ``[B, Sq, QH, D]`` in q's dtype.

    On CUDA tensors it launches the hand-written kernel of the route
    ``flash_route(q.dtype, head_dim)`` names (float32 or bfloat16,
    contiguous, head_dim in ``KERNEL_HEAD_DIMS``) and adds one to
    ``flash_attention.launches`` and to that route's entry of
    ``flash_attention.launches_by_route``; on CPU tensors it takes
    ``flash_attention_plain``.  Anything else raises ``RuntimeError``.
    """
    _check(q, k, v)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device "
                           f"{q.device}")
    return _launch(q, k, v, causal, scale)


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
