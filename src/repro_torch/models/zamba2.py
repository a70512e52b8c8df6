"""Zamba2 [arXiv:2411.15242]: a Mamba2 backbone and one SHARED attention
block -- the hybrid family.

The port of the JAX package's ``models/zamba2.py``.  ``num_layers`` Mamba2
(SSD) layers; after every ``shared_attn_period`` of them one shared
full-attention + SwiGLU block is invoked (``zamba2-7b``: 81 layers = 13
super-blocks of 6, then 3 leftover layers), each invocation adding its own
low-rank (LoRA) adapters to the shared q/k/v projections.  The shared block
reads ``concat(hidden, the original embedding) [2D]`` through an input
projection; the head is tied (``embed.T``).  Python loops walk the
super-blocks where the JAX package scans; under ``remat == "full"`` with
grad enabled each Mamba2 layer and each shared-block invocation runs under
``torch.utils.checkpoint`` (as ``jax.checkpoint`` there).

Attention goes through ``models/attention.py``: a prefill (the cache
empty, or no cache) through ``gqa_attention(impl=cfg.attention_impl)`` --
on the card the flash kernel --, a decode step through
``decode_attention``, the decode kernel where ``cfg.attention_impl ==
"kernel"``.  Where the JAX model runs a prompt of more than one token
against a non-empty cache, it attends over the new chunk alone, which is
not attention over the cache; the port refuses that call.

Parameter dict (the JAX tree's names and layouts, so
``repro_torch.convert.model_params_from_numpy`` copies it as it is):

  embed        [V, D]
  mamba/       stacked [L, ...]: in_proj, conv_w, conv_b, A_log, D,
               dt_bias, norm_scale, out_proj (``models/mamba2.py``)
  mamba_norm   {scale [L, D]}
  shared/      in_proj [2D, D], attn_norm/mlp_norm {scale [D]}, wq, wk,
               wv, wo, w_gate, w_up, w_down
  lora/        qa/ka/va [n_inv, D, r], qb [n_inv, r, QH*HD],
               kb/vb [n_inv, r, KH*HD]
  final_norm   {scale [D]}

The cache holds each layer's Mamba2 state and each invocation's keys and
values; the port writes them in place and keeps ``length`` on the host.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, dtype_of
from repro_torch.device import resolve_device
from repro_torch.models import mamba2 as m2
from repro_torch.models.attention import decode_attention, gqa_attention
from repro_torch.models.layers import (apply_rope, init_linear,
                                       mask_padded_vocab, rms_norm, rope,
                                       swiglu, unbind_layers)

__all__ = ["init_params", "param_shapes", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step", "ZambaCache", "check_supported"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's model lacks."""
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"family {cfg.family!r}: models.zamba2 serves the hybrid family")
    if cfg.shared_attn_period <= 0 or cfg.ssm_state <= 0:
        raise NotImplementedError(
            "models.zamba2 needs shared_attn_period > 0 and ssm_state > 0")
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save the matmul outputs, recompute the rest) has "
            "no torch counterpart yet (ROADMAP Queue 1, remat=\"dots\"); use "
            "'full' or 'none'")


def _invocations(cfg: ModelConfig) -> int:
    """How many times the shared block runs: once after each full
    super-block of ``shared_attn_period`` layers (the leftover layers run
    without it)."""
    return cfg.num_layers // cfg.shared_attn_period


# -----------------------------------------------------------------------------
# init
# -----------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (tuples), keyed as ``init_params``."""
    check_supported(cfg)
    n_inv = _invocations(cfg)
    n, d, hd, f, r = (cfg.num_layers, cfg.d_model, cfg.head_dim, cfg.d_ff,
                      cfg.lora_rank)
    qh, kh = cfg.num_heads, cfg.num_kv_heads
    return {
        "embed": (cfg.padded_vocab, d),
        "mamba": m2.mamba2_shapes(cfg, (n,)),
        "mamba_norm": {"scale": (n, d)},
        "shared": {"in_proj": (2 * d, d), "attn_norm": {"scale": (d,)},
                   "mlp_norm": {"scale": (d,)}, "wq": (d, qh * hd),
                   "wk": (d, kh * hd), "wv": (d, kh * hd),
                   "wo": (qh * hd, d), "w_gate": (d, f), "w_up": (d, f),
                   "w_down": (f, d)},
        "lora": {"qa": (n_inv, d, r), "qb": (n_inv, r, qh * hd),
                 "ka": (n_inv, d, r), "kb": (n_inv, r, kh * hd),
                 "va": (n_inv, d, r), "vb": (n_inv, r, kh * hd)},
        "final_norm": {"scale": (d,)},
    }


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device: "torch.device | str | None" = None) -> dict:
    """Random parameters drawn from ``generator`` on ``device`` (default
    ``"cuda"``; the generator must live there too) with the JAX package's
    scales: projections ``normal / sqrt(d_in)``, the embedding ``0.02 *
    normal``, the LoRA ``*a`` ``0.02 * normal`` and ``*b`` zero, norm
    scales one in float32, the Mamba2 layers by ``mamba2.init_mamba2``.
    The numbers differ from the JAX package's for the same seed."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    dtype = dtype_of(cfg.param_dtype)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    def linear(shape, scale=None):
        return init_linear(generator, *shape[-2:], dtype=dtype, scale=scale,
                           device=device, lead=shape[:-2])

    shared = {k: ({"scale": ones(s["scale"])} if isinstance(s, dict)
                  else linear(s)) for k, s in shapes["shared"].items()}
    lora = {k: (linear(s, 0.02) if k.endswith("a")
                else torch.zeros(s, dtype=dtype, device=device))
            for k, s in shapes["lora"].items()}
    return {
        "embed": linear(shapes["embed"], 0.02),
        "mamba": m2.init_mamba2(generator, cfg, dtype, device=device,
                                lead=(cfg.num_layers,)),
        "mamba_norm": {"scale": ones(shapes["mamba_norm"]["scale"])},
        "shared": shared,
        "lora": lora,
        "final_norm": {"scale": ones(shapes["final_norm"]["scale"])},
    }


# -----------------------------------------------------------------------------
# the shared attention block
# -----------------------------------------------------------------------------


def _shared_attn(shared: dict, lora: dict, h: torch.Tensor,
                 emb0: torch.Tensor, cfg: ModelConfig, cos: torch.Tensor,
                 sin: torch.Tensor, cache=None) -> torch.Tensor:
    """One invocation with its LoRA slice ``lora``.  ``cache = (k_cache,
    v_cache, length)`` (the invocation's ``[B, S_max, KH, HD]`` tensors):
    the new keys and values are written at ``length`` in place."""
    b, s, _ = h.shape
    qh, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = torch.cat([h, emb0], dim=-1) @ shared["in_proj"]
    x = rms_norm(x, shared["attn_norm"]["scale"])
    q = (x @ shared["wq"] + (x @ lora["qa"]) @ lora["qb"]).reshape(
        b, s, qh, hd)
    k = (x @ shared["wk"] + (x @ lora["ka"]) @ lora["kb"]).reshape(
        b, s, kh, hd)
    v = (x @ shared["wv"] + (x @ lora["va"]) @ lora["vb"]).reshape(
        b, s, kh, hd)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if cache is not None:
        k_cache, v_cache, length = cache
        k_cache[:, length:length + s] = k.to(k_cache.dtype)
        v_cache[:, length:length + s] = v.to(v_cache.dtype)
    if cache is not None and s == 1:
        impl = "kernel" if cfg.attention_impl == "kernel" else "einsum"
        out = decode_attention(q, k_cache, v_cache, length + 1, impl=impl)
    else:   # a prefill: the cache was empty
        out = gqa_attention(q, k, v, causal=True, impl=cfg.attention_impl,
                            chunk=cfg.attention_chunk)
    h = h + out.reshape(b, s, qh * hd) @ shared["wo"]
    mlp_in = rms_norm(h, shared["mlp_norm"]["scale"])
    return h + swiglu(mlp_in, shared["w_gate"], shared["w_up"],
                      shared["w_down"])


# -----------------------------------------------------------------------------
# the whole model
# -----------------------------------------------------------------------------


@dataclasses.dataclass
class ZambaCache:
    ssm: m2.Mamba2State    # stacked [L, ...]: ssm [L, B, H, P, N] float32
    attn_k: torch.Tensor   # [n_inv, B, S_max, KH, HD]
    attn_v: torch.Tensor
    length: int            # valid rows; kept on the host (no sync a step)


def _run(params: dict, h: torch.Tensor, cfg: ModelConfig,
         cache: ZambaCache | None) -> torch.Tensor:
    """The backbone and the shared block over ``h`` ``[B, S, D]``; with a
    cache, every layer's state and every invocation's keys and values are
    written into it in place."""
    period = cfg.shared_attn_period
    b, s, _ = h.shape
    emb0 = h
    start = cache.length if cache is not None else 0
    pos = (start + torch.arange(s, device=h.device))[None, :].expand(b, s)
    cos, sin = rope(pos, cfg.head_dim, theta=cfg.rope_theta)
    decode = cache is not None and s == 1
    remat = cfg.remat == "full" and torch.is_grad_enabled()

    def mamba_layer(p, norm_scale, hcur, i):
        x = rms_norm(hcur, norm_scale)
        if cache is None:
            out, _ = m2.mamba2_forward(p, x, cfg)
            return hcur + out
        st = m2.Mamba2State(ssm=cache.ssm.ssm[i], conv=cache.ssm.conv[i])
        if decode:
            out, st = m2.mamba2_decode_step(p, x, cfg, st)
        else:
            out, st = m2.mamba2_forward(p, x, cfg, state=st)
        cache.ssm.ssm[i].copy_(st.ssm)
        cache.ssm.conv[i].copy_(st.conv)
        return hcur + out

    def attn(lora, hcur, j):
        kv = None if cache is None else (cache.attn_k[j], cache.attn_v[j],
                                         cache.length)
        return _shared_attn(params["shared"], lora, hcur, emb0, cfg, cos,
                            sin, cache=kv)

    def call(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    layers = unbind_layers({"layers": params["mamba"]})
    norms = params["mamba_norm"]["scale"].unbind(0)
    loras = unbind_layers({"layers": params["lora"]})
    for i in range(cfg.num_layers):
        h = call(mamba_layer, layers[i], norms[i], h, i)
        if (i + 1) % period == 0:          # after each super-block
            j = (i + 1) // period - 1
            h = call(attn, loras[j], h, j)
    return h


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    return params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))


def _logits(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"]["scale"])
    return mask_padded_vocab(h @ params["embed"].T.to(h.dtype),
                             cfg.vocab_size)


def forward(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """-> logits ``[B, S, V]`` (the JAX ``forward``'s first output; its
    second, the auxiliary loss, is zero for this family)."""
    return _logits(params, _run(params, _embed(params, batch["tokens"], cfg),
                                cfg, None), cfg)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy (the JAX ``loss_fn``): logits cast to
    float32, log-softmax, the negative log-likelihood of ``labels``
    averaged over the positions with ``labels >= 0``."""
    logits = forward(params, batch, cfg).float()
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype: torch.dtype | None = None,
               device: "torch.device | str | None" = None) -> ZambaCache:
    """A zeroed cache on ``device`` (default ``"cuda"``): every layer's
    Mamba2 state (``ssm`` float32, the conv tail in ``dtype``) and each
    invocation's ``max_len`` rows of keys and values in ``dtype`` (default
    the parameter dtype)."""
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.param_dtype)
    n_inv = _invocations(cfg)
    d_inner = cfg.d_model * cfg.ssm_expand
    nheads = d_inner // cfg.ssm_headdim
    conv_ch = d_inner + 2 * cfg.ssm_state
    kv = (n_inv, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return ZambaCache(
        ssm=m2.Mamba2State(
            ssm=torch.zeros((cfg.num_layers, batch, nheads, cfg.ssm_headdim,
                             cfg.ssm_state), dtype=torch.float32,
                            device=device),
            conv=torch.zeros((cfg.num_layers, batch, cfg.ssm_conv - 1,
                              conv_ch), dtype=dtype, device=device)),
        attn_k=torch.zeros(kv, dtype=dtype, device=device),
        attn_v=torch.zeros(kv, dtype=dtype, device=device),
        length=0)


def prefill(params: dict, batch: dict, cfg: ModelConfig, cache: ZambaCache
            ) -> tuple[torch.Tensor, ZambaCache]:
    """Run ``batch["tokens"]`` ``[B, S]`` from the cache's state, write
    every layer's new state and the keys and values into it, and return
    the last position's logits ``[B, 1, V]`` and the cache ``S`` rows
    longer.  ``S > 1`` needs an empty cache (see the module docstring)."""
    h = _embed(params, batch["tokens"], cfg)
    s = h.shape[1]
    if s > 1 and cache.length > 0:
        raise NotImplementedError(
            f"zamba2: a prompt of {s} tokens on a cache of {cache.length} "
            f"rows; the JAX model attends over the new chunk alone there, "
            f"not over the cache, and the port refuses it (prefill an empty "
            f"cache, then decode one token a step)")
    if cache.length + s > cache.attn_k.shape[2]:
        raise RuntimeError(f"KV cache full: length {cache.length} + {s} > "
                           f"{cache.attn_k.shape[2]}")
    h = _run(params, h, cfg, cache)
    logits = _logits(params, h[:, -1:], cfg)
    return logits, dataclasses.replace(cache, length=cache.length + s)


def decode_step(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                cache: ZambaCache) -> tuple[torch.Tensor, ZambaCache]:
    """One decode step.  tokens ``[B, 1]`` -> (logits ``[B, 1, V]``, the
    cache one row longer)."""
    return prefill(params, {"tokens": tokens}, cfg, cache)
