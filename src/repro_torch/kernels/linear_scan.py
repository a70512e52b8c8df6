"""The RWKV-6 wkv recurrence (gated linear scan): the hand-written CUDA
kernel and its plain PyTorch version.

Port of the JAX package's ``kernels/linear_scan.py`` (the Pallas TPU kernel
``wkv_linear_scan``).  Per (batch, head), with a ``[K, V = K]`` float32
state::

    y_t     = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t     = diag(exp(logw_t)) S_{t-1} + k_t v_t^T

Three pieces:

``wkv_plain``        plain PyTorch ops, a twin of the JAX model's own
                     ``models/rwkv6.py::wkv_chunked`` in the same op order
                     (the ``[Q, Q, K]`` decay tensor with its exponent
                     masked before ``exp``, the bonus term, the incoming
                     state term, the state update).  The CPU path and the
                     card's yardstick.
``wkv_linear_scan``  the kernel wrapper: CUDA tensors only, launched on the
                     current stream (``csrc/wkv_linear_scan.cu``); anything
                     it does not take raises.
``wkv``              the model's entry: a CUDA tensor with
                     ``impl="kernel"`` goes to the kernel, a CPU tensor (or
                     any other impl) to ``wkv_plain``.  No ``try`` falls
                     back: a failed build or launch raises.

Shapes follow the JAX package: r/k/v/logw ``[B, S, H, K]`` (logw float32,
<= 0), u ``[H, K]`` float32, the state ``[B, H, K, K]`` float32; y comes
back in r's dtype.  Both take an incoming state (``state0``, zero when
None), as ``wkv_chunked`` and ``repro.kernels.ref.wkv_ref`` do, so one
function serves prefill and every decode step.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["wkv", "wkv_linear_scan", "wkv_plain", "KERNEL_DTYPES",
           "KERNEL_HEAD_DIMS"]

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (16, 32, 64)

_lib = None


def _load_lib():
    """The built kernel library (compiled at first use, never at import)."""
    global _lib
    if _lib is None:
        from repro_torch.kernels import build
        lib = build.load_library("wkv_linear_scan")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.wkv_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                   i32, i32, i32, i32, i32, ptr]
        lib.wkv_launch.restype = i32
        lib.wkv_error_string.argtypes = [i32]
        lib.wkv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _chunk_len(s: int, chunk: int) -> int:
    """The chunk length of ``wkv_chunked``: ``min(chunk, S)``, which must
    divide ``S`` (the JAX function asserts it)."""
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"wkv: sequence length {s} is not a multiple of "
                         f"the chunk {q}")
    return q


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, *,
              state0: torch.Tensor | None = None, chunk: int = 64
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact chunked wkv in float32 (``wkv_chunked``): returns (y
    ``[B, S, H, K]`` in r's dtype, the final state ``[B, H, K, K]``
    float32).  Raises ``ValueError`` when ``min(chunk, S)`` does not divide
    ``S``.  A chunk of Q steps materialises ``[B, Q, Q, H, K]`` float32
    temporaries."""
    b, s, h, kd = r.shape
    q = _chunk_len(s, chunk)

    def resh(x):
        return x.float().reshape(b, s // q, q, h, kd).transpose(0, 1)

    rq, kq, vq, wq = resh(r), resh(k), resh(v), resh(logw)
    u = u.float()
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=r.device),
                      diagonal=-1)                       # strict s < t
    state = (torch.zeros((b, h, kd, kd), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float())
    ys = []
    for rb, kb, vb, wb in zip(rq, kq, vq, wq):           # [B, q, H, K]
        cum = torch.cumsum(wb, dim=1)
        cum_tm1 = cum - wb                               # cum_{t-1}
        # D[t,s,k] = exp(cum_tm1[t] - cum[s]) for s < t; the exponent is
        # masked before exp (s > t entries are positive and can overflow)
        expo = cum_tm1[:, :, None] - cum[:, None, :, :, :]
        expo = expo.masked_fill(~mask[None, :, :, None, None], float("-inf"))
        att = torch.einsum("btshk,bshk->bths", rb[:, :, None] * expo.exp_(),
                           kb)
        y = torch.einsum("bths,bshv->bthv", att, vb)
        # diagonal (bonus) term
        y = y + (rb * u * kb).sum(-1, keepdim=True) * vb
        # incoming state term: r_t . diag(exp(cum_{t-1})) state
        rdec = rb * torch.exp(cum_tm1)
        y = y + torch.einsum("bthk,bhkv->bthv", rdec, state)
        # state update
        dec_end = torch.exp(cum[:, -1:] - cum)           # [B, q, H, K]
        state = (torch.exp(cum[:, -1])[..., None] * state
                 + torch.einsum("bthk,bthv->bhkv", kb * dec_end, vb))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, h, kd)
    return y.to(r.dtype), state


def _check(r, k, v, logw, u, state0) -> None:
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape \
            or logw.shape != r.shape:
        raise RuntimeError(f"wkv_linear_scan: r, k, v, logw [B,S,H,K] of "
                           f"one shape expected, got {tuple(r.shape)}, "
                           f"{tuple(k.shape)}, {tuple(v.shape)}, "
                           f"{tuple(logw.shape)}")
    b, s, h, kd = r.shape
    if s < 1 or tuple(u.shape) != (h, kd):
        raise RuntimeError(f"wkv_linear_scan: S >= 1 and u [H,K] = "
                           f"{(h, kd)} expected, got S={s}, u "
                           f"{tuple(u.shape)}")
    if state0 is not None and tuple(state0.shape) != (b, h, kd, kd):
        raise RuntimeError(f"wkv_linear_scan: state0 {(b, h, kd, kd)} "
                           f"expected, got {tuple(state0.shape)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in KERNEL_DTYPES:
        raise RuntimeError(f"wkv_linear_scan: r, k, v must be all float32 "
                           f"or all bfloat16, got {r.dtype}, {k.dtype}, "
                           f"{v.dtype}")
    for name, t in (("logw", logw), ("u", u), ("state0", state0)):
        if t is not None and t.dtype != torch.float32:
            raise RuntimeError(f"wkv_linear_scan: {name} must be float32, "
                               f"got {t.dtype}")
    if kd not in KERNEL_HEAD_DIMS:
        raise RuntimeError(f"wkv_linear_scan: the kernel takes K in "
                           f"{KERNEL_HEAD_DIMS}, got {kd}")


def wkv_linear_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logw: torch.Tensor, u: torch.Tensor, *,
                    state0: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The wkv recurrence on the card: (y ``[B, S, H, K]`` in r's dtype,
    the final state ``[B, H, K, K]`` float32), from ``state0`` (zero when
    None).  r/k/v float32 or bfloat16 (all alike), logw/u/state0 float32,
    all contiguous CUDA tensors on one device, K in ``KERNEL_HEAD_DIMS``,
    any ``S >= 1``; anything else raises ``RuntimeError``.  Each launch
    adds one to ``wkv_linear_scan.launches``."""
    _check(r, k, v, logw, u, state0)
    tensors = [t for t in (r, k, v, logw, u, state0) if t is not None]
    if any(t.device.type != "cuda" for t in tensors) \
            or len({t.device for t in tensors}) != 1:
        raise RuntimeError(f"wkv_linear_scan: every tensor on one CUDA "
                           f"device expected, got "
                           f"{sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise RuntimeError("wkv_linear_scan: the kernel takes contiguous "
                           "tensors")
    b, s, h, kd = r.shape
    lib = _load_lib()
    y = torch.empty_like(r)
    state = torch.empty((b, h, kd, kd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.wkv_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                            logw.data_ptr(), u.data_ptr(),
                            None if state0 is None else state0.data_ptr(),
                            y.data_ptr(), state.data_ptr(), b, s, h, kd,
                            KERNEL_DTYPES[r.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"wkv_linear_scan: CUDA error {rc}: "
                           f"{lib.wkv_error_string(rc).decode()}")
    wkv_linear_scan.launches += 1
    return y, state


wkv_linear_scan.launches = 0


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logw: torch.Tensor, u: torch.Tensor, *,
        state0: torch.Tensor | None = None, chunk: int = 64,
        impl: str = "kernel") -> tuple[torch.Tensor, torch.Tensor]:
    """The model's wkv: ``wkv_linear_scan`` for CUDA tensors with
    ``impl == "kernel"``, ``wkv_plain`` (chunk ``min(chunk, S)``) for CPU
    tensors and for any other impl.  Either way ``min(chunk, S)`` must
    divide ``S`` (``ValueError`` otherwise), so both routes accept the same
    inputs, as ``wkv_chunked`` does."""
    _chunk_len(r.shape[1], chunk)
    if impl == "kernel" and r.device.type != "cpu":
        return wkv_linear_scan(r, k, v, logw, u, state0=state0)
    return wkv_plain(r, k, v, logw, u, state0=state0, chunk=chunk)
