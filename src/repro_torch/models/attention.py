"""Attention: GQA with qk-norm, three interchangeable prefill impls and two
decode impls.

The port of the JAX package's ``models/attention.py``.  Prefill
implementations (``impl`` of ``gqa_attention``):

  naive        the full ``[S, S]`` score matrix; reference semantics.
  chunked      blockwise online softmax over KV chunks (a Python loop where
               the JAX package scans): O(S * chunk) score memory.
  kernel       ``repro_torch.kernels.flash_attention``: the hand-written
               CUDA kernel on the card, its plain version on the CPU.  It
               takes the place of the JAX package's ``"pallas"``.  It has
               no backward: under autograd it raises (on the CPU too,
               rather than quietly differentiating the plain version).

Decode (``decode_attention``): ``"einsum"`` is the JAX package's ``"jnp"``
path (grouped einsums, masking by cache length); ``"kernel"`` is
``repro_torch.kernels.decode_attention``.  With ``return_lse`` both also
give each head's log-sum-exp over the rows they read, and
``merge_decode_partials`` merges the outputs of the ranks that each hold
some rows of a cache whose sequence axis lies on a mesh's model axis (the
flash-decode merge of the kernel's splits, across ranks).

``attention_tp`` is one rank's attention in a partitioned step (every
family's: the transformer's, enc-dec's self- and cross-attention,
zamba2's shared block), from the rank's column blocks of q, k and v to
the rank's columns of the output that its row-parallel ``wo`` block
reads; ``fill_cache`` / ``write_new_rows`` write a prefill's and a decode
step's rows into the rank's block of a cache.

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
from repro_torch.meta import loop_repeats, repeated
from repro_torch.models.layers import NEG_INF, apply_rope, rms_norm
from repro_torch.sharding import collectives

__all__ = ["gqa_attention", "decode_attention", "merge_decode_partials",
           "attention_tp", "fill_cache", "write_new_rows"]


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
    # on the meta device a representative chunk stands for the middle ones
    # (``repro_torch.meta.loop_repeats``)
    for ci, n_rep in enumerate(loop_repeats(n_chunks, q)):
        if n_rep:
            with repeated(n_rep):
                m, l, acc = _chunk_step(q32, k, v, m, l, acc, qpos, ci,
                                        chunk=chunk, causal=causal,
                                        scale=scale)
    return acc / l.clamp_min(1e-37).permute(0, 3, 1, 2)[..., None]


def _chunk_step(q32, k, v, m, l, acc, qpos, ci: int, *, chunk: int,
                causal: bool, scale: float):
    """One KV chunk of the online softmax: the new (max, sum, acc)."""
    sk = k.shape[1]
    kb = k[:, ci * chunk:(ci + 1) * chunk]
    vb = v[:, ci * chunk:(ci + 1) * chunk]
    n = kb.shape[1]
    if n < chunk:            # the JAX scan zero-pads the last chunk
        pad = (0, 0, 0, 0, 0, chunk - n)
        kb = torch.nn.functional.pad(kb, pad)
        vb = torch.nn.functional.pad(vb, pad)
    s = torch.einsum("bqkgd,bskd->bkgqs", q32, kb.float()) * scale
    kpos = ci * chunk + torch.arange(chunk, device=q32.device)[None, :]
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
    return m_new, l, acc


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
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise NotImplementedError(
                "attention_impl='kernel' has no backward (the flash kernel, "
                "like the JAX package's, is forward only): train with "
                "'chunked', as the JAX package's train path does")
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
                     impl: str = "einsum", scale: float | None = None,
                     return_lse: bool = False):
    """Single-token attention against a KV cache.

    q: ``[B, 1, QH, D]``; caches ``[B, S_max, KH, D]``; ``length`` (a
    Python int) valid cache rows.  ``"einsum"`` reads the whole cache and
    masks; ``"kernel"`` reads only the rows below ``length``.  With
    ``return_lse``: ``(out, lse)``, ``lse`` the float32 log-sum-exp
    ``[B, QH]`` of each head's scaled scores over the valid rows; at
    ``length == 0`` nothing is read or launched, ``out`` is zero and
    ``lse`` is ``-inf`` (a rank holding no valid row).
    """
    b, sq, qh, d = q.shape
    kh = k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    if return_lse and length == 0:
        return (torch.zeros_like(q),
                torch.full((b, qh), float("-inf"), dtype=torch.float32,
                           device=q.device))
    if impl == "kernel":
        return _decode_kernel.decode_attention(q, k_cache, v_cache, length,
                                               scale=scale,
                                               return_lse=return_lse)
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
    out = out.reshape(b, sq, qh, d).to(q.dtype)
    if return_lse:     # s [B, KH, G, 1, S_max] -> [B, QH]
        return out, torch.logsumexp(s, dim=-1).reshape(b, qh)
    return out


def merge_decode_partials(out: torch.Tensor, lse: torch.Tensor, group, *,
                          own_columns: bool) -> torch.Tensor:
    """The attention over every rank's rows from each rank's ``out``
    ``[B, 1, QH, D]`` and ``lse`` ``[B, QH]`` over its own rows (``-inf``
    where it holds none): the log-sum-exps are all-gathered over the
    model-axis ``group``, each rank weighs its output by ``exp(lse -
    LSE)`` in float32, and the weighted outputs are summed over the group
    -- by a reduce-scatter that leaves each rank its block of the ``QH *
    D`` columns (``own_columns``, ``[B, 1, QH * D / m]``: what its
    row-parallel ``wo`` block reads), else by an all-reduce (``[B, 1,
    QH * D]``).  Cast to ``out``'s dtype.  A group of one returns ``out``
    as it is."""
    b, sq, qh, d = out.shape
    if collectives.size(group) == 1:
        return out.reshape(b, sq, qh * d)
    every = collectives.all_gather(lse[None], 0, group)        # [m, B, QH]
    top = every.amax(0)
    weight = torch.exp(lse - top) / torch.exp(every - top).sum(0)
    part = (out.float() * weight[:, None, :, None]).reshape(b, sq, qh * d)
    if own_columns:
        part = collectives.reduce_scatter(part, -1, group)
    else:
        part = collectives.all_reduce(part, group)
    return part.to(out.dtype)


# -----------------------------------------------------------------------------
# a rank's attention in a partitioned step
# -----------------------------------------------------------------------------


def _write_rows(cache_l: torch.Tensor, rows: torch.Tensor, first: int
                ) -> None:
    """Write ``rows`` ``[B, n, KH, HD]`` into one layer's cache of the
    rank from its row ``first``."""
    n = rows.shape[1]
    cache_l[:, first:first + n] = rows.to(cache_l.dtype)


def write_new_rows(tp, cache, k, v, *, split: bool) -> int:
    """A decode step's cache write in a partitioned step: the new rows
    (every KV head) at ``length``, on the rank whose rows they are (every
    rank where the cache's rows are not ``split`` over the model axis);
    returns how many of the rank's rows are valid after it (0: the rank
    holds none yet).  ``k = v = None`` writes nothing: a cache read at
    ``length`` rows (enc-dec's cross cache)."""
    k_cache, v_cache, length = cache
    rows = k_cache.shape[1]
    s = 0 if k is None else k.shape[1]
    first = tp.model_rank * rows if split else 0
    if s and first <= length < first + rows:
        _write_rows(k_cache, k, length - first)
        _write_rows(v_cache, v, length - first)
    return min(max(length + s - first, 0), rows)


def fill_cache(tp, fill, k, v, *, whole: bool, split: bool) -> None:
    """A prefill's cache write: the ``S`` prompt rows of ``k`` / ``v``
    (every KV head where ``whole``, else the rank's KV heads) into the
    rank's cache rows -- all of them without a ``split`` cache, else rows
    ``r*R .. (r+1)*R`` of the prompt, sent to their rank by an all-to-all
    where the rank holds only its own heads."""
    k_cache, v_cache = fill
    rows, s = k_cache.shape[1], k.shape[1]
    if not split:
        if not whole:
            k = collectives.all_gather(k, 2, tp.model_group)
            v = collectives.all_gather(v, 2, tp.model_group)
        _write_rows(k_cache, k, 0)
        _write_rows(v_cache, v, 0)
        return
    m, r = tp.model_size, tp.model_rank
    if whole or m == 1:
        lo, hi = r * rows, min((r + 1) * rows, s)
        if hi > lo:
            _write_rows(k_cache, k[:, lo:hi], 0)
            _write_rows(v_cache, v[:, lo:hi], 0)
        return
    pad = (0, 0, 0, 0, 0, m * rows - s)
    for t, cache_l in ((k, k_cache), (v, v_cache)):
        t = torch.nn.functional.pad(t, pad)       # [B, m*R, KH/m, HD]
        _write_rows(cache_l, collectives.all_to_all(t, 1, 2, tp.model_group),
                    0)


def attention_tp(q: torch.Tensor, k: "torch.Tensor | None",
                 v: "torch.Tensor | None", tp, *, heads: tuple,
                 causal: bool, impl: str, chunk: int, rope=None,
                 scales: tuple = (None, None), cache=None, fill=None,
                 split: bool = False) -> torch.Tensor:
    """One rank's attention in a partitioned step, from the rank's column
    blocks of the projections -- q ``[B, Sq, QH*HD/m]``, k / v ``[B, Sk,
    KH*HD/m]`` (``heads = (QH, KH, HD)``, the whole counts) -- to the
    rank's columns ``[B, Sq, QH*HD/m]`` of the attention output, what its
    row-parallel ``wo`` block reads.  ``rope = (cos, sin)`` rotates q and k
    (none for cross-attention); ``scales`` are qk-norm's per-head scales;
    ``causal`` and ``impl`` / ``chunk`` as ``gqa_attention`` takes them.

    Prefill (``cache`` None): over the rank's own query heads where the
    heads divide the model axis (its K/V heads gathered over the axis
    where the KV heads do not), else over every head with Q, K and V
    gathered, keeping the rank's columns.  ``fill = (k_cache, v_cache)``
    writes the keys and values into the rank's cache block
    (``fill_cache``; ``split``: its rows lie on the model axis).

    Decode (``cache = (k_cache, v_cache, length)``): every head of the
    new token, its rows written on the rank that owns them
    (``write_new_rows``; ``k = v = None`` reads a cache of ``length``
    rows and writes nothing), attention over the rank's rows with the
    decode kernel's log-sum-exp and, for a ``split`` cache, the ranks'
    partials merged into the rank's columns
    (``merge_decode_partials``)."""
    b, sq = q.shape[:2]
    qh, kh, hd = heads
    group, m, r = tp.model_group, tp.model_size, tp.model_rank
    c = qh * hd // m

    def shaped(t, n, scale):
        t = t.reshape(b, t.shape[1], n, hd)
        return t if scale is None else rms_norm(t, scale)

    def rot(t):
        return t if rope is None else apply_rope(t, *rope)

    if cache is not None:
        q = rot(shaped(collectives.gather_summed(q, -1, group), qh,
                       scales[0]))
        if k is not None:
            k = rot(shaped(collectives.gather_summed(k, -1, group), kh,
                           scales[1]))
            v = shaped(collectives.gather_summed(v, -1, group), kh, None)
        valid = write_new_rows(tp, cache, k, v, split=split)
        dimpl = "kernel" if impl == "kernel" else "einsum"
        out, lse = decode_attention(q, cache[0], cache[1], valid,
                                    impl=dimpl, return_lse=True)
        if split:
            return merge_decode_partials(out, lse, group, own_columns=True)
        return out.reshape(b, sq, -1).narrow(-1, r * c, c)

    if qh % m == 0 and (kh % m == 0 or m % kh == 0):
        # the rank's query heads, and the KV heads they read
        nq = qh // m
        q = rot(shaped(q, nq, scales[0]))
        if kh % m == 0:
            k = rot(shaped(k, kh // m, scales[1]))
            v = shaped(v, kh // m, None)
            if fill is not None:
                fill_cache(tp, fill, k, v, whole=m == 1, split=split)
            kq, vq = k, v
        else:
            k = rot(shaped(collectives.gather_summed(k, -1, group), kh,
                           scales[1]))
            v = shaped(collectives.gather_summed(v, -1, group), kh, None)
            if fill is not None:
                fill_cache(tp, fill, k, v, whole=True, split=split)
            j = (r * nq) // (qh // kh)
            kq, vq = k[:, :, j:j + 1], v[:, :, j:j + 1]
        out = gqa_attention(q, kq, vq, causal=causal, impl=impl,
                            chunk=chunk)
        return out.reshape(b, sq, -1)
    # every head on every rank, the rank's columns of the output
    q = rot(shaped(collectives.gather_summed(q, -1, group), qh, scales[0]))
    k = rot(shaped(collectives.gather_summed(k, -1, group), kh, scales[1]))
    v = shaped(collectives.gather_summed(v, -1, group), kh, None)
    if fill is not None:
        fill_cache(tp, fill, k, v, whole=True, split=split)
    out = gqa_attention(q, k, v, causal=causal, impl=impl, chunk=chunk)
    return out.reshape(b, sq, -1).narrow(-1, r * c, c)
