"""Decoder-only transformer LM: the dense family.

The port of the JAX package's ``models/transformer.py`` for
``family == "dense"``: GQA attention with RoPE and optional per-head
qk-norm (qwen3), a SwiGLU or GELU FFN, tied or separate head, the training
loss ``loss_fn`` (each block recomputed in the backward pass under
``remat == "full"``), and the serving pair ``prefill`` / ``decode_step``
over a preallocated KV cache.
MoE, VLM (M-RoPE, patch embeddings) and the other families raise
``NotImplementedError`` (ROADMAP Queue 1 item 11).  The JAX ``shard(...)``
constraints are no-ops without a mesh; the port has no mesh, so they are
left out.

Parameter dict (the JAX tree's names and layouts, so
``repro_torch.convert.model_params_from_numpy`` copies it as it is):

  embed            [V, D]             (V = cfg.padded_vocab)
  layers/          stacked [L, ...]:
    attn_norm, mlp_norm: {scale [D]} (+ bias [D] for layer norm)
    wq [D, QH*HD], wk [D, KH*HD], wv [D, KH*HD], wo [QH*HD, D]
    (qk_norm) q_scale [HD], k_scale [HD]
    swiglu: w_gate [D, F], w_up [D, F], w_down [F, D]; gelu: w_up, w_down
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
from repro_torch.models.attention import decode_attention, gqa_attention
from repro_torch.models.layers import (apply_rope, gelu_mlp, init_linear,
                                       layer_norm, mask_padded_vocab,
                                       rms_norm, rope, swiglu, unbind_layers)

__all__ = ["init_params", "param_shapes", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step", "KVCache", "attention_block",
           "check_supported"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's model lacks."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item "
            f"11); models.transformer serves the dense family")
    if cfg.mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE waits for the VLM family (ROADMAP Queue 1 item 11)")
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save the matmul outputs, recompute the rest) has "
            "no torch counterpart yet (ROADMAP Queue 1 item 11); use 'full' "
            "or 'none'")


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
    if cfg.act == "swiglu":
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
    embedding; norm scales (and qk-norm scales) one, in float32.  The
    numbers differ from the JAX package's for the same seed."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    dtype = dtype_of(cfg.param_dtype)
    n = cfg.num_layers
    layers = {}
    for name, shape in shapes["layers"].items():
        if isinstance(shape, dict):          # norms
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


def _ffn(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act == "swiglu":
        return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    return gelu_mlp(h, p["w_up"], p["w_down"])


def _block(p: dict, h: torch.Tensor, cfg: ModelConfig, cos, sin, *,
           cache=None) -> torch.Tensor:
    h = h + attention_block(p, _norm(h, p["attn_norm"], cfg), cfg, cos, sin,
                            cache=cache)
    return h + _ffn(p, _norm(h, p["mlp_norm"], cfg), cfg)


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig):
    if set(batch) - {"tokens", "positions", "labels"}:
        raise NotImplementedError(
            f"inputs {sorted(set(batch) - {'tokens', 'positions', 'labels'})}"
            f" belong to the VLM/audio frontends (ROADMAP Queue 1 item 11)")
    return params["embed"][batch["tokens"].long()].to(
        dtype_of(cfg.compute_dtype))


def _positions(batch: dict, s: int, b: int, device) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(s, device=device)[None, :].expand(b, s)


def _logits(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = _norm(h, params["final_norm"], cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return mask_padded_vocab(h @ head.to(h.dtype), cfg.vocab_size)


# -----------------------------------------------------------------------------
# forward (training / prefill without cache)
# -----------------------------------------------------------------------------


def forward(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """-> logits ``[B, S, V]`` (the JAX ``forward``'s first output; the
    dense family has no auxiliary loss).  With ``cfg.remat == "full"`` and
    grad enabled each block runs under ``torch.utils.checkpoint`` (its
    activations are recomputed in the backward pass, as under
    ``jax.checkpoint``)."""
    h = _embed_inputs(params, batch, cfg)
    b, s, _ = h.shape
    cos, sin = rope(_positions(batch, s, b, h.device), cfg.head_dim,
                    theta=cfg.rope_theta)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for p in unbind_layers(params):
        if remat:
            h = checkpoint(_block, p, h, cfg, cos, sin, use_reentrant=False)
        else:
            h = _block(p, h, cfg, cos, sin)
    return _logits(params, h, cfg)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy over the token positions (the JAX
    ``loss_fn``): logits cast to float32, log-softmax, the negative
    log-likelihood of ``labels`` averaged over the positions with
    ``labels >= 0``.  The dense family adds no router loss."""
    logits = forward(params, batch, cfg)
    labels = batch["labels"].long()
    logits = logits[:, -labels.shape[1]:].float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


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
    cos, sin = rope(_positions(batch, s, b, h.device), cfg.head_dim,
                    theta=cfg.rope_theta)
    for i, p in enumerate(unbind_layers(params)):
        attn_in = _norm(h, p["attn_norm"], cfg)
        q, k, v = _qkv(p, attn_in, cfg, cos, sin)
        cache.k[i, :, :s] = k.to(cache.k.dtype)
        cache.v[i, :, :s] = v.to(cache.v.dtype)
        out = gqa_attention(q, k, v, causal=True, impl=cfg.attention_impl,
                            chunk=cfg.attention_chunk)
        h = h + out.reshape(b, s, -1) @ p["wo"]
        h = h + _ffn(p, _norm(h, p["mlp_norm"], cfg), cfg)
    logits = _logits(params, h[:, -1:], cfg)
    return logits, KVCache(k=cache.k, v=cache.v, length=s)


def decode_step(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """One decode step.  tokens ``[B, 1]`` -> (logits ``[B, 1, V]``, the
    cache one row longer)."""
    h = params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    b, s, _ = h.shape
    if cache.length + s > cache.k.shape[2]:
        raise RuntimeError(f"KV cache full: length {cache.length} + {s} > "
                           f"{cache.k.shape[2]}")
    pos = torch.full((b, s), cache.length, device=h.device)
    cos, sin = rope(pos, cfg.head_dim, theta=cfg.rope_theta)
    for i, p in enumerate(unbind_layers(params)):
        h = _block(p, h, cfg, cos, sin,
                   cache=(cache.k[i], cache.v[i], cache.length))
    logits = _logits(params, h, cfg)
    return logits, KVCache(k=cache.k, v=cache.v, length=cache.length + s)
