"""Attention: GQA with qk-norm, three interchangeable prefill impls and two
decode impls.

The port of the JAX package's ``models/attention.py``.  Prefill
implementations (``impl`` of ``gqa_attention``):

  naive        the full ``[S, S]`` score matrix; reference semantics.
  chunked      blockwise online softmax over KV chunks (a Python loop where
               the JAX package scans): O(S * chunk) score memory.
  kernel       ``repro_torch.kernels.flash_attention``: the hand-written
               CUDA kernel on the card, its plain version on the CPU.  It
               takes the place of the JAX package's ``"pallas"``.

Decode (``decode_attention``): ``"einsum"`` is the JAX package's ``"jnp"``
path (grouped einsums, masking by cache length); ``"kernel"`` is
``repro_torch.kernels.decode_attention``.

GQA is computed grouped (q reshaped to ``[B, S, KH, G, D]``) in the einsum
paths, so KV is never repeated there.  Where the JAX package takes bf16
operands with ``preferred_element_type=float32``, the port upcasts the
operands to float32 first: a product of two bf16 values is exact in
float32, so both compute bf16 products summed in float32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode_kernel
from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.models.layers import NEG_INF

__all__ = ["gqa_attention", "decode_attention"]


def _group_q(q: torch.Tensor, kh: int) -> torch.Tensor:
    b, s, qh, d = q.shape
    return q.reshape(b, s, kh, qh // kh, d)


def _naive_attention(q, k, v, *, causal: bool, scale: float) -> torch.Tensor:
    # q: [B, Sq, KH, G, D], k/v: [B, Sk, KH, D] -> f32 [B, Sq, KH, G, D]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())


def _chunked_attention(q, k, v, *, causal: bool, scale: float,
                       chunk: int = 512) -> torch.Tensor:
    """Blockwise online-softmax attention (score memory O(Sq * chunk)).
    q: ``[B, Sq, KH, G, D]``; k/v: ``[B, Sk, KH, D]``."""
    b, sq, kh, g, d = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    n_chunks = (sk + chunk - 1) // chunk
    q32 = q.float()
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, kh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kh, g, d), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        n = kb.shape[1]
        if n < chunk:            # the JAX scan zero-pads the last chunk
            pad = (0, 0, 0, 0, 0, chunk - n)
            kb = torch.nn.functional.pad(kb, pad)
            vb = torch.nn.functional.pad(vb, pad)
        s = torch.einsum("bqkgd,bskd->bkgqs", q32, kb.float()) * scale
        kpos = ci * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = kpos < sk
        if causal:
            mask = mask & (qpos >= kpos)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        upd = torch.einsum("bkgqs,bskd->bqkgd", p.to(vb.dtype).float(),
                           vb.float())
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + upd
        m = m_new
    return acc / l.clamp_min(1e-37).permute(0, 3, 1, 2)[..., None]


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, impl: str = "chunked",
                  chunk: int = 512,
                  scale: float | None = None) -> torch.Tensor:
    """Grouped-query attention.  q: ``[B, S, QH, D]``; k/v: ``[B, S, KH,
    D]`` -> ``[B, S, QH, D]`` in q's dtype."""
    b, sq, qh, d = q.shape
    kh = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    if impl == "kernel":
        return _flash_kernel.flash_attention(q, k, v, causal=causal,
                                             scale=scale)
    qg = _group_q(q, kh)
    if impl == "naive":
        out = _naive_attention(qg, k, v, causal=causal, scale=scale)
    elif impl == "chunked":
        out = _chunked_attention(qg, k, v, causal=causal, scale=scale,
                                 chunk=chunk)
    else:
        raise ValueError(f"unknown attention impl {impl!r}; one of "
                         f"naive, chunked, kernel")
    return out.reshape(b, sq, qh, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, *,
                     impl: str = "einsum",
                     scale: float | None = None) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: ``[B, 1, QH, D]``; caches ``[B, S_max, KH, D]``; ``length`` (a
    Python int) valid cache rows.  ``"einsum"`` reads the whole cache and
    masks; ``"kernel"`` reads only the rows below ``length``.
    """
    b, sq, qh, d = q.shape
    kh = k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    if impl == "kernel":
        return _decode_kernel.decode_attention(q, k_cache, v_cache, length,
                                               scale=scale)
    if impl != "einsum":
        raise ValueError(f"unknown decode impl {impl!r}; one of "
                         f"einsum, kernel")
    qg = _group_q(q, kh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                     k_cache.float()) * scale
    valid = torch.arange(k_cache.shape[1], device=q.device) < length
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, sq, qh, d).to(q.dtype)
