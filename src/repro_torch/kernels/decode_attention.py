"""Flash-decode: one-query GQA attention against a preallocated KV cache,
the hand-written CUDA kernel and its plain PyTorch version.

Port of the JAX package's ``kernels/decode_attention.py`` (the Pallas TPU
kernel ``decode_attention``).  Two pieces:

``decode_attention_plain``  plain PyTorch ops that mirror
                            ``repro.kernels.ref.decode_attention_ref``: f32
                            scores over GQA-expanded caches, rows at or past
                            ``length`` masked to ``-inf``, a softmax, the
                            result cast to ``q.dtype``.  The CPU path and the
                            card's yardstick.
``decode_attention``        the wrapper: CUDA tensors go to the kernel
                            (``csrc/decode_attention.cu``: one clustered
                            launch, the output its only allocation), CPU
                            tensors to the plain version, anything else
                            raises.

Shapes follow the JAX package: q ``[B, 1, QH, D]``, caches
``[B, S_max, KH, D]``.  ``length`` (the number of valid cache rows) is a
Python int here, where the JAX cache keeps a device scalar: the port's
``KVCache`` holds its length on the host, so a decode step needs no
device-to-host read, and the kernel's grid covers only the rows below it.
The JAX wrapper asserts ``S_max % block_k == 0``; this kernel masks any
``S_max`` (the tests hold it at shapes the JAX wrapper accepts too).
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["decode_attention", "decode_attention_plain", "KERNEL_DTYPES",
           "KERNEL_HEAD_DIMS", "KERNEL_GROUPS"]

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (16, 32, 64, 112, 128)
KERNEL_GROUPS = (1, 2, 4, 8)

_lib = None


def _load_lib():
    """The built kernel library (compiled at first use, never at import)."""
    global _lib
    if _lib is None:
        from repro_torch.kernels import build
        lib = build.load_library("decode_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.da_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                  i32, i32, ctypes.c_float, i32, ptr]
        lib.da_launch.restype = i32
        lib.da_error_string.argtypes = [i32]
        lib.da_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, length: int, *,
                           scale: float | None = None) -> torch.Tensor:
    """Single-query attention in f32 over the first ``length`` cache rows,
    cast to ``q.dtype`` (``ref.decode_attention_ref``)."""
    qh, d = q.shape[2], q.shape[3]
    group = qh // k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kx = k_cache.repeat_interleave(group, dim=2).float()
    vx = v_cache.repeat_interleave(group, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * scale
    valid = torch.arange(k_cache.shape[1], device=q.device) < int(length)
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vx).to(q.dtype)


def _check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           length: int) -> None:
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or v_cache.shape != k_cache.shape:
        raise RuntimeError(f"decode_attention: q [B,1,QH,D], caches "
                           f"[B,S_max,KH,D] expected, got {tuple(q.shape)}, "
                           f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, _, qh, d = q.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d \
            or qh % k_cache.shape[2]:
        raise RuntimeError(f"decode_attention: q {tuple(q.shape)} and caches "
                           f"{tuple(k_cache.shape)} do not match")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise RuntimeError(f"decode_attention: q and cache dtypes differ "
                           f"({q.dtype}, {k_cache.dtype}, {v_cache.dtype})")
    if not isinstance(length, int) or not 1 <= length <= k_cache.shape[1]:
        raise RuntimeError(f"decode_attention: length must be an int in "
                           f"[1, {k_cache.shape[1]}], got {length!r}")


def _launch(q, k_cache, v_cache, length: int, scale: float) -> torch.Tensor:
    if q.dtype not in KERNEL_DTYPES:
        raise RuntimeError(f"decode_attention: the kernel takes float32 or "
                           f"bfloat16, got {q.dtype}")
    b, _, qh, d = q.shape
    s_max, kh = k_cache.shape[1], k_cache.shape[2]
    if d not in KERNEL_HEAD_DIMS or qh // kh not in KERNEL_GROUPS:
        raise RuntimeError(f"decode_attention: the kernel takes head_dim in "
                           f"{KERNEL_HEAD_DIMS} and q heads per kv head in "
                           f"{KERNEL_GROUPS}, got {d} and {qh // kh}")
    if not (q.device == k_cache.device == v_cache.device):
        raise RuntimeError("decode_attention: q and caches on different "
                           "devices")
    for t in (q, k_cache, v_cache):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise RuntimeError("decode_attention: the kernel takes "
                               "contiguous, 16-byte aligned tensors")
    lib = _load_lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.da_launch(q.data_ptr(), k_cache.data_ptr(),
                           v_cache.data_ptr(), out.data_ptr(), b, s_max, qh,
                           kh, d, length, float(scale),
                           KERNEL_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: CUDA error {rc}: "
                           f"{lib.da_error_string(rc).decode()}")
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, *,
                     scale: float | None = None) -> torch.Tensor:
    """One-query attention, q ``[B, 1, QH, D]`` against caches
    ``[B, S_max, KH, D]`` masked at ``length`` (a Python int, ``1 <= length
    <= S_max``) -> ``[B, 1, QH, D]`` in q's dtype.

    On CUDA tensors it launches the hand-written kernel once (float32 or
    bfloat16, contiguous; the output is the only allocation) and adds one
    to ``decode_attention.launches``; on
    CPU tensors it takes ``decode_attention_plain``.  Anything else raises
    ``RuntimeError``.
    """
    _check(q, k_cache, v_cache, length)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, length,
                                      scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attention: no kernel for device "
                           f"{q.device}")
    return _launch(q, k_cache, v_cache, length, scale)


decode_attention.launches = 0
