"""Encoder-decoder transformer: the audio family (seamless-m4t).

The port of the JAX package's ``models/encdec.py``.  Encoder: bidirectional
self-attention over stub audio-frame embeddings (``batch["embeds"]``
``[B, S_enc, D]``; the speech frontend is out of scope, as there).
Decoder: causal self-attention, then cross-attention over the encoder's
output, text token embeddings in and a separate head out.  Layer norms
with bias, a GELU FFN, RoPE on self-attention (over ``0 .. S_enc - 1`` in
the encoder, ``0 .. S_dec - 1`` in a decoder prefill, ``cache.length`` at
a decode step) and none on cross-attention.  Python loops walk the layers
where the JAX package scans; under ``remat`` ``"full"`` or ``"dots"`` with
grad enabled each encoder and decoder block runs under
``torch.utils.checkpoint`` (as ``jax.checkpoint`` there, under both).

Attention goes through ``models/attention.py``: every prefill attention
through ``gqa_attention(impl=cfg.attention_impl)`` -- on the card the flash
kernel, for the encoder's full self-attention, the decoder's causal one
and the cross-attention whose ``Sq`` (decoder tokens) differs from ``Sk``
(encoder frames) --, each decode step's two through ``decode_attention``,
the decode kernel where ``cfg.attention_impl == "kernel"`` (the JAX
decode path calls its einsum version; both compute the same function).
The cross cache is read at ``length = S_enc``, all its rows.

Parameter dict (the JAX tree's names and layouts, so
``repro_torch.convert.model_params_from_numpy`` copies it as it is):

  embed        [V, D]           (V = cfg.padded_vocab)
  encoder/     stacked [L_enc, ...]: attn_norm, mlp_norm {scale, bias} [D];
               attn/{wq [D, QH*HD], wk, wv [D, KH*HD], wo [QH*HD, D]};
               w_up [D, F], w_down [F, D]
  decoder/     stacked [L_dec, ...]: self_norm, cross_norm, mlp_norm;
               self_attn/{wq, wk, wv, wo}, cross_attn/{wq, wk, wv, wo};
               w_up, w_down
  enc_norm, dec_norm  {scale, bias} [D]
  lm_head      [D, V]

``prefill`` and ``decode_step`` write the decoder's keys and values, and
the cross keys and values ``prefill`` computes from the encoder's output,
into the cache's tensors in place, and keep ``length`` on the host.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, dtype_of
from repro_torch.device import resolve_device
from repro_torch.models.attention import decode_attention, gqa_attention
from repro_torch.models.layers import (apply_rope, gelu_mlp, init_linear,
                                       layer_norm, mask_padded_vocab,
                                       remat_block, rope, unbind_layers)

__all__ = ["init_params", "param_shapes", "encode", "decode_stack",
           "forward", "loss_fn", "init_cache", "prefill", "decode_step",
           "EncDecCache", "check_supported"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's model lacks."""
    if cfg.family != "audio" or not cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"family {cfg.family!r}: models.encdec serves the audio "
            f"(encoder-decoder) family")


# -----------------------------------------------------------------------------
# init
# -----------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (tuples), keyed as ``init_params``."""
    check_supported(cfg)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    qd, kd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def norm(*lead):
        return {"scale": (*lead, d), "bias": (*lead, d)}

    def attn(n):
        return {"wq": (n, d, qd), "wk": (n, d, kd), "wv": (n, d, kd),
                "wo": (n, qd, d)}

    n_enc, n_dec = cfg.num_layers, cfg.num_decoder_layers
    return {
        "embed": (v, d),
        "encoder": {"attn_norm": norm(n_enc), "mlp_norm": norm(n_enc),
                    "attn": attn(n_enc), "w_up": (n_enc, d, f),
                    "w_down": (n_enc, f, d)},
        "decoder": {"self_norm": norm(n_dec), "cross_norm": norm(n_dec),
                    "mlp_norm": norm(n_dec), "self_attn": attn(n_dec),
                    "cross_attn": attn(n_dec), "w_up": (n_dec, d, f),
                    "w_down": (n_dec, f, d)},
        "enc_norm": norm(), "dec_norm": norm(),
        "lm_head": (d, v),
    }


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device: "torch.device | str | None" = None) -> dict:
    """Random parameters drawn from ``generator`` on ``device`` (default
    ``"cuda"``; the generator must live there too) with the JAX package's
    scales: ``normal / sqrt(d_in)`` for every projection, ``0.02 * normal``
    for the embedding; norm scales one and biases zero, in float32.  Each
    leaf is allocated once and filled a block at a time
    (``layers.init_linear``).  The numbers differ from the JAX package's for
    the same seed."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)

    def build(shapes):
        out = {}
        for name, shape in shapes.items():
            if name in ("scale", "bias"):
                out[name] = (torch.ones if name == "scale" else torch.zeros)(
                    shape, dtype=torch.float32, device=device)
            elif isinstance(shape, dict):
                out[name] = build(shape)
            else:
                out[name] = init_linear(
                    generator, *shape[-2:], dtype=dtype, device=device,
                    scale=0.02 if name == "embed" else None,
                    lead=shape[:-2])
        return out

    return build(param_shapes(cfg))


# -----------------------------------------------------------------------------
# blocks
# -----------------------------------------------------------------------------


def _norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    return layer_norm(x, p["scale"], p["bias"])


def _proj_qkv(p: dict, xq: torch.Tensor, xkv: torch.Tensor,
              cfg: ModelConfig):
    b, sq, _ = xq.shape
    skv = xkv.shape[1]
    qh, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (xq @ p["wq"]).reshape(b, sq, qh, hd)
    k = (xkv @ p["wk"]).reshape(b, skv, kh, hd)
    v = (xkv @ p["wv"]).reshape(b, skv, kh, hd)
    return q, k, v


def _attend(p: dict, q, k, v, cfg: ModelConfig, *, causal: bool):
    b, sq = q.shape[:2]
    out = gqa_attention(q, k, v, causal=causal, impl=cfg.attention_impl,
                        chunk=cfg.attention_chunk)
    return out.reshape(b, sq, -1) @ p["wo"]


def _attn(p: dict, xq, xkv, cfg: ModelConfig, *, causal: bool, cos=None,
          sin=None) -> torch.Tensor:
    q, k, v = _proj_qkv(p, xq, xkv, cfg)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return _attend(p, q, k, v, cfg, causal=causal)


def _enc_block(p: dict, h: torch.Tensor, cfg: ModelConfig, cos, sin
               ) -> torch.Tensor:
    x = _norm(h, p["attn_norm"])
    h = h + _attn(p["attn"], x, x, cfg, causal=False, cos=cos, sin=sin)
    return h + gelu_mlp(_norm(h, p["mlp_norm"]), p["w_up"], p["w_down"])


def _dec_block(p: dict, h: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig, cos, sin) -> torch.Tensor:
    x = _norm(h, p["self_norm"])
    h = h + _attn(p["self_attn"], x, x, cfg, causal=True, cos=cos, sin=sin)
    x = _norm(h, p["cross_norm"])
    h = h + _attn(p["cross_attn"], x, enc_out, cfg, causal=False)
    return h + gelu_mlp(_norm(h, p["mlp_norm"]), p["w_up"], p["w_down"])


def _positions(b: int, s: int, cfg: ModelConfig, device):
    """float32 cos/sin ``[B, S, HD/2]`` of positions ``0 .. S-1``."""
    pos = torch.arange(s, device=device)[None, :].expand(b, s)
    return rope(pos, cfg.head_dim, theta=cfg.rope_theta)


def _stack(layers: dict, h: torch.Tensor, cfg: ModelConfig, block, *args
           ) -> torch.Tensor:
    """``block(p, h, *args)`` over the stacked ``layers``, each under
    ``torch.utils.checkpoint`` with ``remat`` ``"full"`` or ``"dots"`` and
    grad enabled (``layers.remat_block``)."""
    for p in unbind_layers({"layers": layers}):
        h = remat_block(cfg.remat, block, p, h, *args)
    return h


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """The encoder over frame embeddings ``[B, S_enc, D]`` (in the compute
    dtype), ending in ``enc_norm``."""
    h = frames.to(dtype_of(cfg.compute_dtype))
    cos, sin = _positions(h.shape[0], h.shape[1], cfg, h.device)
    h = _stack(params["encoder"], h, cfg, _enc_block, cfg, cos, sin)
    return _norm(h, params["enc_norm"])


def decode_stack(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The decoder over tokens ``[B, S_dec]`` attending to ``enc_out``,
    ending in ``dec_norm``."""
    h = params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    cos, sin = _positions(h.shape[0], h.shape[1], cfg, h.device)
    h = _stack(params["decoder"], h, cfg, _dec_block, enc_out, cfg, cos,
               sin)
    return _norm(h, params["dec_norm"])


def _head(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return mask_padded_vocab(h @ params["lm_head"].to(h.dtype),
                             cfg.vocab_size)


# -----------------------------------------------------------------------------
# model API
# -----------------------------------------------------------------------------


def forward(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """-> logits ``[B, S_dec, V]`` over ``batch["tokens"]`` given
    ``batch["embeds"]`` (the JAX ``forward``'s first output; the family has
    no auxiliary loss)."""
    enc_out = encode(params, batch["embeds"], cfg)
    h = decode_stack(params, batch["tokens"], enc_out, cfg)
    return _head(params, h, cfg)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy over the decoder's positions (the JAX
    ``loss_fn``): logits cast to float32, log-softmax, the negative
    log-likelihood of ``labels`` averaged over the positions with
    ``labels >= 0``."""
    logits = forward(params, batch, cfg).float()
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


@dataclasses.dataclass
class EncDecCache:
    enc_out: torch.Tensor   # [B, S_enc, D]
    self_k: torch.Tensor    # [L_dec, B, S_max, KH, HD]
    self_v: torch.Tensor
    cross_k: torch.Tensor   # [L_dec, B, S_enc, KH, HD] (from enc_out)
    cross_v: torch.Tensor
    length: int             # decoder tokens in the cache; kept on the host


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               enc_len: int = 0, dtype: torch.dtype | None = None,
               device: "torch.device | str | None" = None) -> EncDecCache:
    """A zeroed cache on ``device`` (default ``"cuda"``): ``max_len``
    decoder rows a layer, and ``enc_len`` encoder rows for ``enc_out`` and
    the cross keys and values (the prompt's frame count; ``prefill``
    fills them)."""
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.param_dtype)
    lead = (cfg.num_decoder_layers, batch)
    heads = (cfg.num_kv_heads, cfg.head_dim)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return EncDecCache(enc_out=zeros(batch, enc_len, cfg.d_model),
                       self_k=zeros(*lead, max_len, *heads),
                       self_v=zeros(*lead, max_len, *heads),
                       cross_k=zeros(*lead, enc_len, *heads),
                       cross_v=zeros(*lead, enc_len, *heads), length=0)


def prefill(params: dict, batch: dict, cfg: ModelConfig, cache: EncDecCache
            ) -> tuple[torch.Tensor, EncDecCache]:
    """Encode ``batch["embeds"]``, compute each decoder layer's cross keys
    and values from the encoder's output into the cache, and run the
    decoder over ``batch["tokens"]``, filling its first ``S_dec`` rows.
    Returns the last position's logits ``[B, 1, V]`` and the cache at
    length ``S_dec``.  The cache's ``enc_len`` must be the frame count."""
    enc_out = encode(params, batch["embeds"], cfg)
    b, s_enc = enc_out.shape[:2]
    if cache.cross_k.shape[2] != s_enc:
        raise ValueError(f"cache holds {cache.cross_k.shape[2]} encoder "
                         f"rows, the prompt {s_enc} frames "
                         f"(init_cache(..., enc_len={s_enc}))")
    tokens = batch["tokens"]
    h = params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    s = h.shape[1]
    cos, sin = _positions(b, s, cfg, h.device)
    for i, p in enumerate(unbind_layers({"layers": params["decoder"]})):
        x = _norm(h, p["self_norm"])
        q, k, v = _proj_qkv(p["self_attn"], x, x, cfg)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        cache.self_k[i, :, :s] = k.to(cache.self_k.dtype)
        cache.self_v[i, :, :s] = v.to(cache.self_v.dtype)
        h = h + _attend(p["self_attn"], q, k, v, cfg, causal=True)
        x = _norm(h, p["cross_norm"])
        q, k, v = _proj_qkv(p["cross_attn"], x, enc_out, cfg)
        cache.cross_k[i] = k.to(cache.cross_k.dtype)
        cache.cross_v[i] = v.to(cache.cross_v.dtype)
        h = h + _attend(p["cross_attn"], q, k, v, cfg, causal=False)
        h = h + gelu_mlp(_norm(h, p["mlp_norm"]), p["w_up"], p["w_down"])
    logits = _head(params, _norm(h[:, -1:], params["dec_norm"]), cfg)
    return logits, dataclasses.replace(cache, enc_out=enc_out, length=s)


def decode_step(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                cache: EncDecCache) -> tuple[torch.Tensor, EncDecCache]:
    """One decoder step.  tokens ``[B, 1]`` -> (logits ``[B, 1, V]``, the
    cache one row longer): causal self-attention over the decoder cache at
    position ``cache.length``, cross-attention over all ``S_enc`` rows of
    the cross cache."""
    compute = dtype_of(cfg.compute_dtype)
    h = params["embed"][tokens.long()].to(compute)
    b, s, _ = h.shape
    length = cache.length
    if length + s > cache.self_k.shape[2]:
        raise RuntimeError(f"KV cache full: length {length} + {s} > "
                           f"{cache.self_k.shape[2]}")
    cos, sin = rope(torch.full((b, s), length, device=h.device),
                    cfg.head_dim, theta=cfg.rope_theta)
    impl = "kernel" if cfg.attention_impl == "kernel" else "einsum"
    enc_len = cache.cross_k.shape[2]
    qh, hd = cfg.num_heads, cfg.head_dim
    for i, p in enumerate(unbind_layers({"layers": params["decoder"]})):
        sk, sv = cache.self_k[i], cache.self_v[i]
        x = _norm(h, p["self_norm"])
        q, k, v = _proj_qkv(p["self_attn"], x, x, cfg)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        sk[:, length:length + s] = k.to(sk.dtype)
        sv[:, length:length + s] = v.to(sv.dtype)
        out = decode_attention(q, sk, sv, length + s, impl=impl)
        h = h + out.reshape(b, s, -1) @ p["self_attn"]["wo"]
        x = _norm(h, p["cross_norm"])
        qc = (x @ p["cross_attn"]["wq"]).reshape(b, s, qh, hd)
        out = decode_attention(qc, cache.cross_k[i], cache.cross_v[i],
                               enc_len, impl=impl)
        h = h + out.reshape(b, s, -1) @ p["cross_attn"]["wo"]
        h = h + gelu_mlp(_norm(h, p["mlp_norm"]), p["w_up"], p["w_down"])
    logits = _head(params, _norm(h, params["dec_norm"]), cfg)
    return logits, dataclasses.replace(cache, length=length + s)
