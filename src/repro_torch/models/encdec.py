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

Tensor-parallel compute.  In a rank's partitioned step
(``sharding.api.compute_axes()``, ``launch/steps.py``) each encoder and
decoder layer gathers its FSDP blocks over the DP group; every attention
(the encoder's full one, the decoder's causal and cross ones) runs the
rank's heads column-parallel into a row-parallel ``wo``
(``attention.attention_tp``: flash on the card at the rank's heads), the
GELU FFN column- into row-parallel.  The caches' rows lie on the model
axis (``partition.cache_specs``): a prefill sends each rank its rows of
the decoder's and the cross keys and values, a decode step attends over
the rank's rows of both with the decode kernel's log-sum-exp and merges
the ranks' partials.  ``enc_out`` is whole on the model axis; the cache
keeps the rank's block of its spec (frames over the DP axes).  The
embedding, head and loss are vocabulary-parallel.

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
from repro_torch.models.attention import (attention_tp, decode_attention,
                                          gqa_attention)
from repro_torch.models.layers import (apply_rope, embed_tokens, gelu_mlp,
                                       init_linear, layer_norm, model_split,
                                       next_token_loss, remat_block, rope,
                                       unbind_layers, vocab_logits)
from repro_torch.sharding import collectives as C
from repro_torch.sharding import spmd
from repro_torch.sharding.api import compute_axes

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


_ATTN = ("wq", "wk", "wv", "wo")


def _attn_tp(p: dict, xq, xkv, cfg: ModelConfig, tp, prefix: tuple, *,
             causal: bool, rope=None, cache=None, fill=None,
             field: "str | None" = None) -> torch.Tensor:
    """One rank's attention sub-block (its ``wq`` / ``wk`` / ``wv`` column
    blocks and ``wo`` row block, the leaves under ``prefix``): the rank's
    heads through ``attention.attention_tp``, then the row-parallel
    ``wo`` and one all-reduce.  ``xkv = None`` (a decode step's
    cross-attention) reads ``cache`` and writes nothing; ``field`` names
    the cache field whose split says where its rows lie."""
    for n in _ATTN:
        if not model_split(tp, prefix + (n,)):
            raise NotImplementedError(
                f"enc-dec: {'/'.join(prefix + (n,))} is whole on the model "
                f"axis (its heads do not divide it); the partitioned "
                f"attention takes split projections")
    group = tp.model_group
    x = C.copy_to(xq, group)
    k = v = None
    if xkv is not None:
        xkv = x if xkv is xq else C.copy_to(xkv, group)
        k, v = xkv @ p["wk"], xkv @ p["wv"]
    out = attention_tp(x @ p["wq"], k, v, tp,
                       heads=(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
                       causal=causal, impl=cfg.attention_impl,
                       chunk=cfg.attention_chunk, rope=rope, cache=cache,
                       fill=fill, split=field is not None
                       and tp.cache_split(field))
    return C.reduce_from(out @ p["wo"], group)


def _mlp(p: dict, x: torch.Tensor, tp, prefix: tuple) -> torch.Tensor:
    """The GELU FFN, column- into row-parallel in a partitioned step."""
    group = None
    if tp is not None:
        if not all(model_split(tp, prefix + (n,)) for n in ("w_up",
                                                            "w_down")):
            raise NotImplementedError(
                f"enc-dec: {'/'.join(prefix)}'s FFN is whole on the model "
                f"axis; the partitioned FFN takes split weights")
        group = tp.model_group
    return gelu_mlp(x, p["w_up"], p["w_down"], group=group)


def _layer(p: dict, stack: str):
    """A layer's weights as its compute reads them (in a partitioned step
    their FSDP blocks gathered over the DP group) and the rank's axes."""
    tp = compute_axes()
    if tp is not None:
        p = spmd.fsdp_gather(p, tp, (stack,))
    return p, tp


def _enc_block(p: dict, h: torch.Tensor, cfg: ModelConfig, cos, sin
               ) -> torch.Tensor:
    p, tp = _layer(p, "encoder")
    x = _norm(h, p["attn_norm"])
    if tp is None:
        h = h + _attn(p["attn"], x, x, cfg, causal=False, cos=cos, sin=sin)
    else:
        h = h + _attn_tp(p["attn"], x, x, cfg, tp, ("encoder", "attn"),
                         causal=False, rope=(cos, sin))
    return h + _mlp(p, _norm(h, p["mlp_norm"]), tp, ("encoder",))


def _self_attn(p: dict, x, cfg: ModelConfig, tp, cos, sin, *, fill=None,
               cache=None) -> torch.Tensor:
    """The decoder's causal self-attention sub-block: a prefill (``fill``:
    the layer's cache tensors, its first rows written) or a decode step
    (``cache = (k, v, length)``: the new row written at ``length``)."""
    if tp is not None:
        return _attn_tp(p, x, x, cfg, tp, ("decoder", "self_attn"),
                        causal=True, rope=(cos, sin), cache=cache,
                        fill=fill, field="self_k")
    q, k, v = _proj_qkv(p, x, x, cfg)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if cache is None:
        if fill is not None:
            s = k.shape[1]
            fill[0][:, :s] = k.to(fill[0].dtype)
            fill[1][:, :s] = v.to(fill[1].dtype)
        return _attend(p, q, k, v, cfg, causal=True)
    sk, sv, length = cache
    b, s = q.shape[:2]
    sk[:, length:length + s] = k.to(sk.dtype)
    sv[:, length:length + s] = v.to(sv.dtype)
    out = decode_attention(q, sk, sv, length + s, impl=_decode_impl(cfg))
    return out.reshape(b, s, -1) @ p["wo"]


def _cross_attn(p: dict, x, enc_out, cfg: ModelConfig, tp, *, fill=None,
                cache=None) -> torch.Tensor:
    """The decoder's cross-attention sub-block over ``enc_out`` (a
    prefill: ``fill``, the layer's cross cache, written whole), or over
    the cross cache ``cache = (k, v, S_enc)`` (a decode step,
    ``enc_out`` None)."""
    if tp is not None:
        return _attn_tp(p, x, enc_out, cfg, tp, ("decoder", "cross_attn"),
                        causal=False, cache=cache, fill=fill,
                        field="cross_k")
    if cache is None:
        q, k, v = _proj_qkv(p, x, enc_out, cfg)
        if fill is not None:
            fill[0].copy_(k.to(fill[0].dtype))
            fill[1].copy_(v.to(fill[1].dtype))
        return _attend(p, q, k, v, cfg, causal=False)
    b, s = x.shape[:2]
    qc = (x @ p["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    out = decode_attention(qc, cache[0], cache[1], cache[2],
                           impl=_decode_impl(cfg))
    return out.reshape(b, s, -1) @ p["wo"]


def _decode_impl(cfg: ModelConfig) -> str:
    return "kernel" if cfg.attention_impl == "kernel" else "einsum"


def _dec_block(p: dict, h: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig, cos, sin, *, caches=None, fills=None
               ) -> torch.Tensor:
    """One decoder layer: over ``enc_out`` (training, and a prefill with
    ``fills``: the layer's self and cross cache tensors) or a decode step
    (``caches``: its self cache with the length, its cross cache with
    ``S_enc``; ``enc_out`` None)."""
    p, tp = _layer(p, "decoder")
    fills = fills or (None, None)
    caches = caches or (None, None)
    x = _norm(h, p["self_norm"])
    h = h + _self_attn(p["self_attn"], x, cfg, tp, cos, sin, fill=fills[0],
                       cache=caches[0])
    x = _norm(h, p["cross_norm"])
    h = h + _cross_attn(p["cross_attn"], x, enc_out, cfg, tp, fill=fills[1],
                        cache=caches[1])
    return h + _mlp(p, _norm(h, p["mlp_norm"]), tp, ("decoder",))


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
    h = embed_tokens(params, tokens, cfg)
    cos, sin = _positions(h.shape[0], h.shape[1], cfg, h.device)
    h = _stack(params["decoder"], h, cfg, _dec_block, enc_out, cfg, cos,
               sin)
    return _norm(h, params["dec_norm"])


def _head(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The logits (the rank's vocabulary block in a partitioned step)."""
    return vocab_logits(params, h, cfg)


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
    return next_token_loss(forward(params, batch, cfg).float(),
                           batch["labels"], cfg)


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
    length ``S_dec``.  The cache's ``enc_len`` must be the frame count.
    In a partitioned step the cache holds the rank's blocks: the cross
    cache's rows on the model axis where its spec puts them there, and
    ``enc_out`` the rank's block of its spec (``_enc_out_block``)."""
    enc_out = encode(params, batch["embeds"], cfg)
    b, s_enc = enc_out.shape[:2]
    tp = compute_axes()
    rows = cache.cross_k.shape[2] * (
        tp.model_size if tp is not None and tp.cache_split("cross_k") else 1)
    if rows != s_enc:
        raise ValueError(f"cache holds {rows} encoder rows, the prompt "
                         f"{s_enc} frames (init_cache(..., enc_len="
                         f"{s_enc}))")
    h = embed_tokens(params, batch["tokens"], cfg)
    s = h.shape[1]
    cos, sin = _positions(b, s, cfg, h.device)
    for i, p in enumerate(unbind_layers({"layers": params["decoder"]})):
        h = _dec_block(p, h, enc_out, cfg, cos, sin, fills=(
            (cache.self_k[i], cache.self_v[i]),
            (cache.cross_k[i], cache.cross_v[i])))
    logits = _head(params, _norm(h[:, -1:], params["dec_norm"]), cfg)
    if tp is not None:
        enc_out = _enc_out_block(enc_out, cache.enc_out, tp)
    return logits, dataclasses.replace(cache, enc_out=enc_out, length=s)


def _enc_out_block(enc_out: torch.Tensor, block: torch.Tensor, tp
                   ) -> torch.Tensor:
    """The rank's block (``block``'s shape, ``[B, S_enc / dp, D]`` where
    ``cache_specs`` splits the frames over the DP axes) of the encoder's
    output, from the rank's rows of it (``[B / dp, S_enc, D]`` where the
    batch is split over the DP axes): the DP group's rows exchanged by an
    all-to-all, gathered, or the rank's frames cut."""
    rows_split = enc_out.shape[0] < block.shape[0]
    frames_split = enc_out.shape[1] > block.shape[1]
    if rows_split and frames_split:
        return C.all_to_all(enc_out, 1, 0, tp.dp_group)
    if rows_split:
        return C.all_gather(enc_out, 0, tp.dp_group)
    if frames_split:
        n = block.shape[1]
        return enc_out.narrow(1, C.rank(tp.dp_group) * n, n)
    return enc_out


def decode_step(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                cache: EncDecCache) -> tuple[torch.Tensor, EncDecCache]:
    """One decoder step.  tokens ``[B, 1]`` -> (logits ``[B, 1, V]``, the
    cache one row longer): causal self-attention over the decoder cache at
    position ``cache.length``, cross-attention over all ``S_enc`` rows of
    the cross cache (in a partitioned step each over the rank's rows of
    a split cache, the ranks' partials merged by their log-sum-exps)."""
    h = embed_tokens(params, tokens, cfg)
    b, s, _ = h.shape
    length = cache.length
    tp = compute_axes()

    def whole_rows(field: str) -> int:
        n = getattr(cache, field).shape[2]
        return n * tp.model_size if tp is not None and \
            tp.cache_split(field) else n

    if length + s > whole_rows("self_k"):
        raise RuntimeError(f"KV cache full: length {length} + {s} > "
                           f"{whole_rows('self_k')}")
    cos, sin = rope(torch.full((b, s), length, device=h.device),
                    cfg.head_dim, theta=cfg.rope_theta)
    enc_len = whole_rows("cross_k")
    for i, p in enumerate(unbind_layers({"layers": params["decoder"]})):
        h = _dec_block(p, h, None, cfg, cos, sin, caches=(
            (cache.self_k[i], cache.self_v[i], length),
            (cache.cross_k[i], cache.cross_v[i], enc_len)))
    logits = _head(params, _norm(h, params["dec_norm"]), cfg)
    return logits, dataclasses.replace(cache, length=length + s)
