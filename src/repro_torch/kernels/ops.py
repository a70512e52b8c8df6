"""Public entry points of the port's kernels, with the JAX package's names
and keyword arguments (``repro.kernels.ops``).

Each routes by the device of its tensors: a CUDA tensor launches the
hand-written kernel, a CPU tensor takes the kernel's plain PyTorch version,
anything else raises.  So there is no ``INTERPRET`` switch.  An input that
is not a tensor (a NumPy array, a list) is placed on the default device,
``"cuda"``, first: on a machine without one that raises ``RuntimeError``
(pass CPU tensors to run on the CPU).  JAX's tile parameters (``block_q``,
``block_k``, ``block_t``) are accepted and unused: the CUDA kernels choose
their own tiles.  The port's models call their kernels directly, as the
JAX models do.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import frame_knobs as _knobs
from repro_torch.kernels import linear_scan as _scan
from repro_torch.kernels import quantize as _quant

__all__ = ["flash_attention", "decode_attention", "wkv_linear_scan",
           "quantize_blocks", "dequantize_blocks", "frame_knobs"]


def _tensor(x) -> torch.Tensor:
    """``x`` itself if it is a tensor, else a copy on the default device."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve_device())


def flash_attention(q, k, v, *, causal=True, scale=None, block_q=256,
                    block_k=512):
    """Causal (or full) GQA attention; ``block_q``/``block_k`` unused."""
    return _flash.flash_attention(_tensor(q), _tensor(k), _tensor(v),
                                  causal=causal, scale=scale)


def decode_attention(q, k_cache, v_cache, length, *, scale=None,
                     block_k=512):
    """One-query attention over a cache masked at ``length``, an int or a
    0-dim tensor; a tensor is read with ``int()``, which waits for the
    device.  ``block_k`` unused."""
    return _decode.decode_attention(_tensor(q), _tensor(k_cache),
                                    _tensor(v_cache), int(length),
                                    scale=scale)


def wkv_linear_scan(r, k, v, logw, u, *, block_t=64):
    """The RWKV-6 recurrence from a zero state -> (y, final state).  On
    the card ``block_t`` is unused; on the CPU it is the plain scan's chunk,
    and ``min(block_t, S)`` must divide S, as JAX's tile must."""
    r, k, v, logw, u = (_tensor(t) for t in (r, k, v, logw, u))
    if r.device.type == "cpu":
        return _scan.wkv_plain(r, k, v, logw, u, chunk=block_t)
    return _scan.wkv_linear_scan(r, k, v, logw, u)


def quantize_blocks(x, *, block=(256, 512), bits=8):
    """Per-block symmetric quantization -> (q int8, scales float32)."""
    return _quant.quantize_blocks(_tensor(x), block=block, bits=bits)


def dequantize_blocks(q, scales, *, block=(256, 512), out_dtype=None):
    """``q * scale`` per block, as ``out_dtype`` (default float32)."""
    return _quant.dequantize_blocks(_tensor(q), _tensor(scales), block=block,
                                    out_dtype=out_dtype or torch.float32)


def frame_knobs(frames, prev, *, blur_k=5, pixel_delta=8.0):
    """2x2 mean pool + box blur + knob5 changed fraction on gray planes."""
    return _knobs.frame_knobs(_tensor(frames), _tensor(prev), blur_k=blur_k,
                              pixel_delta=pixel_delta)
