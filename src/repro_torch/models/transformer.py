"""Decoder-only transformer LM: the dense, MoE and VLM families.

The port of the JAX package's ``models/transformer.py`` for
``family in ("dense", "moe", "vlm")``: GQA attention with RoPE (M-RoPE
under ``cfg.mrope_sections``: three position streams, ``positions [3, B,
S]``) and optional per-head qk-norm (qwen3), a SwiGLU or GELU FFN or the
MoE FFN (``models/moe.py``), tied or separate head, the training loss
``loss_fn`` (with the router's auxiliary loss, each block recomputed in
the backward pass under ``remat == "full"``; labels align with the text
tail when patch embeddings come first), and the serving pair ``prefill``
/ ``decode_step`` over a preallocated KV cache, which drop the auxiliary
loss as the JAX package's do.  The VLM's stub frontend: ``batch
["patch_embeds"]`` ``[B, P, D]`` go before the token embeddings, and a
decode step may add ``extra_embeds`` to its token's embedding.  The
audio family's ``embeds`` raise ``NotImplementedError``, naming the
ROADMAP Queue 1 item that ports it.  The JAX ``shard(...)`` constraints
are no-ops without a mesh; the port has no mesh, so they are left out.

Parameter dict (the JAX tree's names and layouts, so
``repro_torch.convert.model_params_from_numpy`` copies it as it is):

  embed            [V, D]             (V = cfg.padded_vocab)
  layers/          stacked [L, ...]:
    attn_norm, mlp_norm: {scale [D]} (+ bias [D] for layer norm)
    wq [D, QH*HD], wk [D, KH*HD], wv [D, KH*HD], wo [QH*HD, D]
    (qk_norm) q_scale [HD], k_scale [HD]
    swiglu: w_gate [D, F], w_up [D, F], w_down [F, D]; gelu: w_up, w_down
    moe: moe/{router [D, E] (float32), w_gate/w_up [E, D, F],
         w_down [E, F, D], (shared experts) shared/{w_gate, w_up, w_down}}
  final_norm       {scale [D]}
  lm_head          [D, V] (absent when tied)

Where the JAX package returns a new cache, the port writes the new keys and
values into the cache's tensors in place (saving a copy of the cache per
step) and returns a ``KVCache`` with the new length over the same tensors.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, dtype_of
from repro_torch.device import resolve_device
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import decode_attention, gqa_attention
from repro_torch.models.layers import (apply_rope, gelu_mlp, init_linear,
                                       layer_norm, mask_padded_vocab,
                                       mrope_frequencies, rms_norm, rope,
                                       swiglu, unbind_layers)

__all__ = ["init_params", "param_shapes", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step", "KVCache", "attention_block",
           "check_supported"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's model lacks."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r}: models.transformer serves the dense, "
            f"MoE and VLM families")
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save the matmul outputs, recompute the rest) has "
            "no torch counterpart yet (ROADMAP Queue 1, remat=\"dots\"); use "
            "'full' or 'none'")


# -----------------------------------------------------------------------------
# init
# -----------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (tuples), keyed as ``init_params``."""
    check_supported(cfg)
    n, d, hd, f = cfg.num_layers, cfg.d_model, cfg.head_dim, cfg.d_ff
    qh, kh, v = cfg.num_heads, cfg.num_kv_heads, cfg.padded_vocab
    norm = {"scale": (n, d)}
    if cfg.norm_type == "layer":
        norm["bias"] = (n, d)
    layers = {"attn_norm": dict(norm), "mlp_norm": dict(norm),
              "wq": (n, d, qh * hd), "wk": (n, d, kh * hd),
              "wv": (n, d, kh * hd), "wo": (n, qh * hd, d)}
    if cfg.qk_norm:
        layers.update(q_scale=(n, hd), k_scale=(n, hd))
    if cfg.family == "moe":
        layers["moe"] = moe_mod.moe_shapes(cfg, (n,))
    elif cfg.act == "swiglu":
        layers.update(w_gate=(n, d, f), w_up=(n, d, f), w_down=(n, f, d))
    else:
        layers.update(w_up=(n, d, f), w_down=(n, f, d))
    shapes = {"embed": (v, d), "layers": layers,
              "final_norm": {k: s[1:] for k, s in norm.items()}}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, v)
    return shapes


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device: "torch.device | str | None" = None) -> dict:
    """Random parameters drawn from ``generator`` on ``device`` (default
    ``"cuda"``; the generator must live there too) with the JAX package's
    scales: ``normal / sqrt(d_in)`` for projections,
    ``normal / sqrt(QH*HD)`` for ``wo``, ``0.02 * normal`` for the
    embedding; norm scales (and qk-norm scales) one, in float32; the MoE
    leaves by ``moe.init_moe``.  Each leaf is allocated once and filled a
    block at a time, so the peak is the parameters plus one float32 block.
    The numbers differ from the JAX package's for the same seed."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    dtype = dtype_of(cfg.param_dtype)
    n = cfg.num_layers
    layers = {}
    for name, shape in shapes["layers"].items():
        if name == "moe":
            layers[name] = moe_mod.init_moe(generator, cfg, dtype,
                                            device=device, lead=(n,))
        elif isinstance(shape, dict):        # norms
            layers[name] = {k: (torch.ones if k == "scale" else torch.zeros)(
                s, dtype=torch.float32, device=device)
                for k, s in shape.items()}
        elif name in ("q_scale", "k_scale"):
            layers[name] = torch.ones(shape, dtype=torch.float32,
                                      device=device)
        else:
            d_in, d_out = shape[1:]
            scale = (1.0 / (cfg.num_heads * cfg.head_dim) ** 0.5
                     if name == "wo" else None)
            layers[name] = init_linear(generator, d_in, d_out, dtype=dtype,
                                       scale=scale, device=device, lead=(n,))
    params = {
        "embed": init_linear(generator, *shapes["embed"], dtype=dtype,
                             scale=0.02, device=device),
        "layers": layers,
        "final_norm": {k: (torch.ones if k == "scale" else torch.zeros)(
            s, dtype=torch.float32, device=device)
            for k, s in shapes["final_norm"].items()},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(generator, *shapes["lm_head"],
                                        dtype=dtype, device=device)
    return params


# -----------------------------------------------------------------------------
# blocks
# -----------------------------------------------------------------------------


def _norm(x, p, cfg):
    if cfg.norm_type == "layer":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def _qkv(p: dict, h: torch.Tensor, cfg: ModelConfig, cos, sin):
    b, s, _ = h.shape
    qh, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (h @ p["wq"]).reshape(b, s, qh, hd)
    k = (h @ p["wk"]).reshape(b, s, kh, hd)
    v = (h @ p["wv"]).reshape(b, s, kh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_scale"])
        k = rms_norm(k, p["k_scale"])
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attention_block(p: dict, h: torch.Tensor, cfg: ModelConfig,
                    cos: torch.Tensor, sin: torch.Tensor, *,
                    cache: "tuple[torch.Tensor, torch.Tensor, int] | None"
                    = None) -> torch.Tensor:
    """The attention sub-block.  ``cache = (k_cache, v_cache, length)``
    (one layer's ``[B, S_max, KH, HD]`` tensors) for decode: the new keys
    and values are written at ``length`` in place.

    One deliberate difference in routing: the JAX package's decode path
    calls ``decode_attention`` without ``impl``, so it never reaches its
    own decode kernel; here ``cfg.attention_impl == "kernel"`` routes decode
    to the decode kernel too.  Both compute the same function."""
    b, s, _ = h.shape
    q, k, v = _qkv(p, h, cfg, cos, sin)
    if cache is None:
        out = gqa_attention(q, k, v, causal=True, impl=cfg.attention_impl,
                            chunk=cfg.attention_chunk)
    else:
        k_cache, v_cache, length = cache
        k_cache[:, length:length + s] = k.to(k_cache.dtype)
        v_cache[:, length:length + s] = v.to(v_cache.dtype)
        impl = "kernel" if cfg.attention_impl == "kernel" else "einsum"
        out = decode_attention(q, k_cache, v_cache, length + s, impl=impl)
    return out.reshape(b, s, -1) @ p["wo"]


def _ffn(p: dict, h: torch.Tensor, cfg: ModelConfig
         ) -> tuple[torch.Tensor, torch.Tensor | float]:
    """The FFN's output and its auxiliary loss: the MoE router's float32
    scalar, or a Python ``0.0`` for the dense family (no device tensor is
    made where nothing reads it)."""
    if cfg.family == "moe":
        return moe_mod.moe_ffn(p["moe"], h, cfg)
    if cfg.act == "swiglu":
        return swiglu(h, p["w_gate"], p["w_up"], p["w_down"]), 0.0
    return gelu_mlp(h, p["w_up"], p["w_down"]), 0.0


def _block(p: dict, h: torch.Tensor, cfg: ModelConfig, cos, sin, *,
           cache=None) -> tuple[torch.Tensor, torch.Tensor | float]:
    h = h + attention_block(p, _norm(h, p["attn_norm"], cfg), cfg, cos, sin,
                            cache=cache)
    ffn_out, aux = _ffn(p, _norm(h, p["mlp_norm"], cfg), cfg)
    return h + ffn_out, aux


_INPUTS = {"tokens", "positions", "labels", "patch_embeds"}


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig):
    """The input sequence in the compute dtype: the VLM's stub patch
    embeddings, then the token embeddings."""
    if set(batch) - _INPUTS:
        raise NotImplementedError(
            f"inputs {sorted(set(batch) - _INPUTS)} belong to the audio "
            f"frontend (ROADMAP Queue 1, the audio enc-dec family)")
    compute = dtype_of(cfg.compute_dtype)
    h = params["embed"][batch["tokens"].long()].to(compute)
    if "patch_embeds" in batch:
        h = torch.cat([batch["patch_embeds"].to(compute), h], dim=1)
    return h


def _positions(batch: dict, cfg: ModelConfig, s: int, b: int,
               device) -> torch.Tensor:
    """``batch["positions"]``, else ``0 .. S-1`` per row: ``[B, S]``, or
    ``[3, B, S]`` (one id in all three streams) under M-RoPE."""
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(s, device=device)[None, :].expand(b, s)
    if cfg.mrope_sections is not None:
        pos = pos[None].expand(3, b, s)
    return pos


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """positions ``[B, S]`` (RoPE) or ``[3, B, S]`` (M-RoPE) -> float32
    cos/sin ``[B, S, HD/2]``."""
    if cfg.mrope_sections is not None:
        return mrope_frequencies(positions, cfg.head_dim, cfg.mrope_sections,
                                 theta=cfg.rope_theta)
    return rope(positions, cfg.head_dim, theta=cfg.rope_theta)


def _logits(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = _norm(h, params["final_norm"], cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return mask_padded_vocab(h @ head.to(h.dtype), cfg.vocab_size)


# -----------------------------------------------------------------------------
# forward (training / prefill without cache)
# -----------------------------------------------------------------------------


def _forward(params: dict, batch: dict, cfg: ModelConfig
             ) -> tuple[torch.Tensor, torch.Tensor | float]:
    """-> (logits ``[B, S, V]``, the auxiliary loss summed over the layers),
    the JAX ``forward``.  With ``cfg.remat == "full"`` and grad enabled each
    block runs under ``torch.utils.checkpoint`` (its activations are
    recomputed in the backward pass, as under ``jax.checkpoint``)."""
    h = _embed_inputs(params, batch, cfg)
    b, s, _ = h.shape
    cos, sin = _rope_tables(cfg, _positions(batch, cfg, s, b, h.device))
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    aux = 0.0
    for p in unbind_layers(params):
        if remat:
            h, a = checkpoint(_block, p, h, cfg, cos, sin,
                              use_reentrant=False)
        else:
            h, a = _block(p, h, cfg, cos, sin)
        aux = aux + a
    return _logits(params, h, cfg), aux


def forward(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """-> logits ``[B, S, V]`` (the JAX ``forward``'s first output)."""
    return _forward(params, batch, cfg)[0]


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy over the token positions plus
    ``cfg.router_aux_coef`` times the auxiliary loss summed over the layers
    (the JAX ``loss_fn``): logits cast to float32, log-softmax, the negative
    log-likelihood of ``labels`` averaged over the positions with
    ``labels >= 0``.  The labels align with the logits' last
    ``labels.shape[1]`` positions (the text tail, after a VLM's patch
    embeddings).  The dense family's auxiliary loss is zero."""
    logits, aux = _forward(params, batch, cfg)
    labels = batch["labels"].long()
    logits = logits[:, -labels.shape[1]:].float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return loss + cfg.router_aux_coef * aux


# -----------------------------------------------------------------------------
# serving: prefill + decode
# -----------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # [L, B, S_max, KH, HD]
    v: torch.Tensor
    length: int            # valid entries; kept on the host (no sync a step)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype: torch.dtype | None = None,
               device: "torch.device | str | None" = None) -> KVCache:
    """A zeroed cache of ``max_len`` rows on ``device`` (default ``"cuda"``;
    zeros, as the JAX package's: the einsum decode path reads every row and
    masks)."""
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.param_dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def prefill(params: dict, batch: dict, cfg: ModelConfig, cache: KVCache
            ) -> tuple[torch.Tensor, KVCache]:
    """Run the full prompt, fill the cache's first ``S`` rows, return the
    last position's logits ``[B, 1, V]`` and the cache at length ``S``."""
    h = _embed_inputs(params, batch, cfg)
    b, s, _ = h.shape
    cos, sin = _rope_tables(cfg, _positions(batch, cfg, s, b, h.device))
    for i, p in enumerate(unbind_layers(params)):
        attn_in = _norm(h, p["attn_norm"], cfg)
        q, k, v = _qkv(p, attn_in, cfg, cos, sin)
        cache.k[i, :, :s] = k.to(cache.k.dtype)
        cache.v[i, :, :s] = v.to(cache.v.dtype)
        out = gqa_attention(q, k, v, causal=True, impl=cfg.attention_impl,
                            chunk=cfg.attention_chunk)
        h = h + out.reshape(b, s, -1) @ p["wo"]
        h = h + _ffn(p, _norm(h, p["mlp_norm"], cfg), cfg)[0]
    logits = _logits(params, h[:, -1:], cfg)
    return logits, KVCache(k=cache.k, v=cache.v, length=s)


def decode_step(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                cache: KVCache, *, extra_embeds: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, KVCache]:
    """One decode step.  tokens ``[B, 1]`` -> (logits ``[B, 1, V]``, the
    cache one row longer).  ``extra_embeds`` ``[B, 1, D]`` (the VLM's
    per-step frontend input) are added to the token's embedding in the
    compute dtype.  The position is ``cache.length``, in all three streams
    under M-RoPE."""
    compute = dtype_of(cfg.compute_dtype)
    h = params["embed"][tokens.long()].to(compute)
    if extra_embeds is not None:
        h = h + extra_embeds.to(compute)
    b, s, _ = h.shape
    if cache.length + s > cache.k.shape[2]:
        raise RuntimeError(f"KV cache full: length {cache.length} + {s} > "
                           f"{cache.k.shape[2]}")
    pos = torch.full((b, s), cache.length, device=h.device)
    if cfg.mrope_sections is not None:
        pos = pos[None].expand(3, b, s)
    cos, sin = _rope_tables(cfg, pos)
    for i, p in enumerate(unbind_layers(params)):
        h, _ = _block(p, h, cfg, cos, sin,
                      cache=(cache.k[i], cache.v[i], cache.length))
    logits = _logits(params, h, cfg)
    return logits, KVCache(k=cache.k, v=cache.v, length=cache.length + s)
