"""Decoder-only transformer LM: the dense, MoE and VLM families.

The port of the JAX package's ``models/transformer.py`` for
``family in ("dense", "moe", "vlm")``: GQA attention with RoPE (M-RoPE
under ``cfg.mrope_sections``: three position streams, ``positions [3, B,
S]``) and optional per-head qk-norm (qwen3), a SwiGLU or GELU FFN or the
MoE FFN (``models/moe.py``), tied or separate head, the training loss
``loss_fn`` (with the router's auxiliary loss; each block recomputed in
the backward pass under ``remat == "full"``, and under ``"dots"`` all but
the outputs of its products without batch dimensions, which are saved, as
JAX's ``checkpoint_dots_with_no_batch_dims``; labels align with the text
tail when patch embeddings come first), and the serving pair ``prefill``
/ ``decode_step`` over a preallocated KV cache, which drop the auxiliary
loss as the JAX package's do.  The VLM's stub frontend: ``batch
["patch_embeds"]`` ``[B, P, D]`` go before the token embeddings, and a
decode step may add ``extra_embeds`` to its token's embedding.  Inputs
of another family (the audio family's ``embeds``, which
``models/encdec.py`` reads) raise ``ValueError``.

Tensor-parallel compute.  Where JAX's ``shard(...)`` constraints let
GSPMD partition the products over the mesh's model axis, a rank of the
port's partitioned step (``launch/steps.py``) runs these functions on its
own blocks while ``sharding.api.compute_axes()`` gives its groups, and
they issue the collectives themselves (``sharding/collectives.py``):

  * each layer gathers its weights' FSDP blocks over the DP group
    (``spmd.fsdp_gather``) inside the layer;
  * attention runs column-parallel into a row-parallel ``wo`` with one
    all-reduce: over the rank's own query heads where the heads divide
    the model axis (its K/V heads gathered over the axis where the KV
    heads do not: 8 KV heads over 16 ranks hold half a head each), else
    over every head with Q, K and V gathered, taking the rank's columns
    of the output for ``wo``;
  * a KV cache whose sequence axis lies on the model axis
    (``partition.cache_specs``) holds the rank's rows of every head: a
    prefill sends each rank its rows (an all-to-all, or a slice of the
    gathered K/V), a decode step writes the new row on the rank that owns
    it, attends over the rank's rows with the decode kernel's
    log-sum-exp and merges the ranks' partials
    (``attention.merge_decode_partials``);
  * the FFN runs column- into row-parallel (``layers.swiglu``), the MoE
    FFN over the rank's experts or its slice of each expert's ``F``
    (``moe.moe_ffn``), each with one all-reduce;
  * the embedding is vocabulary-parallel (a masked lookup of the rank's
    rows, then an all-reduce), the logits stay vocabulary-sharded (the
    rank's columns, ``logits_spec``), and ``loss_fn`` takes a
    vocabulary-parallel cross-entropy.

A weight whose spec leaves the model axis off (its dim does not divide)
is gathered over the axis and that part runs on every rank alike.  At a
model axis of one rank nothing is issued and every product is the
unpartitioned one.

Sequence parallelism.  Under ``cfg.sequence_parallel``, where JAX pins
the residual stream to ``shard(h, "dp", "model", None)`` at the
embedding and after every block, a train or prefill step whose sequence
divides the model axis (``ComputeAxes.seq_split``; decode steps never)
keeps the rank's ``S/m`` rows between sub-blocks: norms and residual
adds run on them.  Each column-parallel entry gathers the rows
(``gather_summed``, in ``copy_to``'s place: its backward reduce-scatters
the ranks' partial gradients, so the two never stand together) and each
row-parallel exit reduce-scatters its sums to the rank's rows
(``scatter_from``, in the all-reduce's place): attention, the FFN, the
MoE's experts, and the vocabulary-split embedding.  Attention weights the
specs leave whole (the heads do not divide the axis) compute every head
over the gathered rows and keep the rank's rows before ``wo``; the
rank's part of such a leaf's gradient, and of the norms' scales, is
summed over the axis (``layers.seq_weight``).  The head gathers the rows
first (the logits keep the sequence whole, as JAX's); a prefill's last
row reaches every rank by an all-gather of each rank's last row; the
VLM's lookup is summed before its patch rows join it, then sliced.  Under
``zero3`` the sequence splits over the model axis all the same while the
weights stay gathered whole over every axis.

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

from repro_torch.configs.base import ModelConfig, dtype_of
from repro_torch.device import resolve_device
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import (attention_tp, decode_attention,
                                          fill_cache, gqa_attention,
                                          merge_decode_partials,
                                          write_new_rows)
from repro_torch.models.layers import (apply_rope, embed_tokens, gather_model,
                                       gelu_mlp, init_linear, layer_norm,
                                       model_split, mrope_frequencies,
                                       next_token_loss, remat_block,
                                       rms_norm, rope, seq_rows, seq_weight,
                                       swiglu, unbind_layers, vocab_logits)
from repro_torch.sharding import collectives as C
from repro_torch.sharding import spmd
from repro_torch.sharding.api import compute_axes

__all__ = ["init_params", "param_shapes", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step", "KVCache", "attention_block",
           "check_supported"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's model lacks."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r}: models.transformer serves the dense, "
            f"MoE and VLM families")


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


def _norm(x, p, cfg, seq: bool = False):
    """The block's norm; with ``seq`` on the rank's rows of a split
    sequence, its scale (and bias) through ``layers.seq_weight``."""
    if seq:
        p = {k: seq_weight(v, compute_axes()) for k, v in p.items()}
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


def _attention_tp(p: dict, h: torch.Tensor, cfg: ModelConfig, cos, sin,
                  tp, *, cache=None, fill=None, seq: bool = False
                  ) -> torch.Tensor:
    """One rank's attention sub-block (see the module docstring), its
    weights the rank's model-axis blocks: ``wq`` ``[D, QH*HD/m]``, ``wk``
    / ``wv`` ``[D, KH*HD/m]``, ``wo`` ``[QH*HD/m, D]``; the attention
    itself is ``attention.attention_tp``.  With ``seq`` ``h`` holds the
    rank's rows of a split sequence: gathered on entry
    (``gather_summed``, in ``copy_to``'s place) and the ``wo`` sums
    reduce-scattered back to the rank's rows."""
    group = tp.model_group
    x = C.gather_summed(h, 1, group) if seq else C.copy_to(h, group)
    scales = (None, None)
    if cfg.qk_norm:
        scales = (C.copy_to(p["q_scale"], group),
                  C.copy_to(p["k_scale"], group))
    out = attention_tp(x @ p["wq"], x @ p["wk"], x @ p["wv"], tp,
                       heads=(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
                       causal=True, impl=cfg.attention_impl,
                       chunk=cfg.attention_chunk, rope=(cos, sin),
                       scales=scales, cache=cache, fill=fill,
                       split=tp.cache_split("k"))
    if seq:
        return C.scatter_from(out @ p["wo"], 1, group)
    return C.reduce_from(out @ p["wo"], group)


def _attention_rows(p: dict, h: torch.Tensor, cfg: ModelConfig, cos, sin,
                    tp, *, fill=None) -> torch.Tensor:
    """A rank's attention sub-block over the rank's rows ``h`` of a split
    sequence, its weights whole on every rank (the heads do not divide
    the model axis, whose specs then leave them whole; or ``zero3``):
    the rows gathered (``gather_summed``), every head over every row as
    without a mesh, the rank's rows of the output kept before ``wo``.
    Nothing is reduced after ``wo``; the weights' gradients, parts from
    the rank's rows, are summed (``layers.seq_weight``)."""
    names = _ATTN + (("q_scale", "k_scale") if cfg.qk_norm else ())
    p = dict(p, **{n: seq_weight(p[n], tp, ("layers", n)) for n in names})
    x = C.gather_summed(h, 1, tp.seq_group)
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, cos, sin)
    if fill is not None:
        fill_cache(tp, fill, k, v, whole=True, split=tp.cache_split("k"))
    out = gqa_attention(q, k, v, causal=True, impl=cfg.attention_impl,
                        chunk=cfg.attention_chunk)
    first, n = tp.own_rows(s)
    return out.reshape(b, s, -1).narrow(1, first, n) @ p["wo"]


_ATTN = ("wq", "wk", "wv", "wo")


def attention_block(p: dict, h: torch.Tensor, cfg: ModelConfig,
                    cos: torch.Tensor, sin: torch.Tensor, *,
                    cache: "tuple[torch.Tensor, torch.Tensor, int] | None"
                    = None,
                    fill: "tuple[torch.Tensor, torch.Tensor] | None" = None,
                    seq: bool = False) -> torch.Tensor:
    """The attention sub-block.  ``cache = (k_cache, v_cache, length)``
    (one layer's ``[B, S_max, KH, HD]`` tensors) for decode: the new keys
    and values are written at ``length`` in place.  ``fill = (k_cache,
    v_cache)`` for a prefill: the prompt's keys and values are written into
    the cache's first rows.  In a partitioned step (``compute_axes()``)
    the rank's part, as the module docstring says; with ``seq``, ``h``
    holds the rank's rows of a split sequence and so does the output.

    One deliberate difference in routing: the JAX package's decode path
    calls ``decode_attention`` without ``impl``, so it never reaches its
    own decode kernel; here ``cfg.attention_impl == "kernel"`` routes decode
    to the decode kernel too.  Both compute the same function."""
    tp = compute_axes()
    if tp is not None:
        if all(model_split(tp, ("layers", n)) for n in _ATTN):
            return _attention_tp(p, h, cfg, cos, sin, tp, cache=cache,
                                 fill=fill, seq=seq)
        if seq:
            return _attention_rows(p, h, cfg, cos, sin, tp, fill=fill)
        p = gather_model(p, tp, _ATTN)
    b, s, _ = h.shape
    q, k, v = _qkv(p, h, cfg, cos, sin)
    if cache is None:
        if fill is not None:
            if tp is not None:
                fill_cache(tp, fill, k, v, whole=True,
                           split=tp.cache_split("k"))
            else:
                fill[0][:, :s] = k.to(fill[0].dtype)
                fill[1][:, :s] = v.to(fill[1].dtype)
        out = gqa_attention(q, k, v, causal=True, impl=cfg.attention_impl,
                            chunk=cfg.attention_chunk)
    else:
        k_cache, v_cache, length = cache
        impl = "kernel" if cfg.attention_impl == "kernel" else "einsum"
        if tp is None:
            k_cache[:, length:length + s] = k.to(k_cache.dtype)
            v_cache[:, length:length + s] = v.to(v_cache.dtype)
            out = decode_attention(q, k_cache, v_cache, length + s,
                                   impl=impl)
        else:
            valid = write_new_rows(tp, cache, k, v,
                                   split=tp.cache_split("k"))
            out, lse = decode_attention(q, k_cache, v_cache, valid,
                                        impl=impl, return_lse=True)
            if tp.cache_split("k"):
                return merge_decode_partials(
                    out, lse, tp.model_group, own_columns=False) @ p["wo"]
    return out.reshape(b, s, -1) @ p["wo"]


_FFN = ("w_gate", "w_up", "w_down")


def _ffn(p: dict, h: torch.Tensor, cfg: ModelConfig, seq: bool = False
         ) -> tuple[torch.Tensor, torch.Tensor | float]:
    """The FFN's output and its auxiliary loss: the MoE router's float32
    scalar, or a Python ``0.0`` for the dense family (no device tensor is
    made where nothing reads it).  In a partitioned step the dense FFN
    runs column- into row-parallel where the specs split its weights over
    the model axis (else gathered whole, alike on every rank).  With
    ``seq`` (``h`` the rank's rows of a split sequence) the split FFN
    gathers the rows and reduce-scatters its sums back to them; whole
    weights compute on the rank's rows (``layers.seq_weight``)."""
    if cfg.family == "moe":
        return moe_mod.moe_ffn(p["moe"], h, cfg, seq=seq)
    tp = compute_axes()
    group = None
    if tp is not None:
        names = _FFN if cfg.act == "swiglu" else _FFN[1:]
        if all(model_split(tp, ("layers", n)) for n in names):
            group = tp.model_group
        elif seq:
            p = dict(p, **{n: seq_weight(p[n], tp, ("layers", n))
                           for n in names})
        else:
            p = gather_model(p, tp, names)
    seq_dim = 1 if seq and group is not None else None
    if cfg.act == "swiglu":
        return swiglu(h, p["w_gate"], p["w_up"], p["w_down"],
                      group=group, seq_dim=seq_dim), 0.0
    return gelu_mlp(h, p["w_up"], p["w_down"], group=group,
                    seq_dim=seq_dim), 0.0


def _layer(p: dict) -> dict:
    """A layer's weights as its compute reads them: in a partitioned step
    their FSDP blocks gathered over the DP group."""
    tp = compute_axes()
    return p if tp is None else spmd.fsdp_gather(p, tp, ("layers",))


def _block(p: dict, h: torch.Tensor, cfg: ModelConfig, cos, sin,
           seq: bool = False, *, cache=None
           ) -> tuple[torch.Tensor, torch.Tensor | float]:
    p = _layer(p)
    h = h + attention_block(p, _norm(h, p["attn_norm"], cfg, seq), cfg, cos,
                            sin, cache=cache, seq=seq)
    ffn_out, aux = _ffn(p, _norm(h, p["mlp_norm"], cfg, seq), cfg, seq)
    return h + ffn_out, aux


_INPUTS = {"tokens", "positions", "labels", "patch_embeds"}


def _seq_len(batch: dict) -> int:
    """The input sequence's length: the VLM's patches and the tokens."""
    s = batch["tokens"].shape[1]
    return s + (batch["patch_embeds"].shape[1] if "patch_embeds" in batch
                else 0)


def _seq_split(batch: dict) -> bool:
    """Whether the step's sequence lies split over the sequence group
    (``ComputeAxes.seq_split``: the ``sequence_parallel`` hint, at a
    length that divides the group)."""
    tp = compute_axes()
    return tp is not None and tp.seq_split(_seq_len(batch))


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig,
                  seq: bool = False):
    """The input sequence in the compute dtype: the VLM's stub patch
    embeddings, then the token embeddings -- with ``seq`` the rank's rows
    of it.  The VLM's patch rows are whole on every rank, so the token
    lookup is summed first (as without ``seq``) and the rank keeps its
    rows of the concatenation (``layers.seq_rows``)."""
    if set(batch) - _INPUTS:
        raise ValueError(
            f"inputs {sorted(set(batch) - _INPUTS)} are not the "
            f"{cfg.family} family's (models.encdec reads the audio "
            f"family's embeds)")
    patches = "patch_embeds" in batch
    h = embed_tokens(params, batch["tokens"], cfg, seq=seq and not patches)
    if patches:
        compute = dtype_of(cfg.compute_dtype)
        h = torch.cat([batch["patch_embeds"].to(compute), h], dim=1)
        if seq:
            h = seq_rows(h, compute_axes())
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


def _logits(params: dict, h: torch.Tensor, cfg: ModelConfig,
            seq: bool = False) -> torch.Tensor:
    """The logits ``[B, S, V]`` -- in a partitioned step the rank's block
    of the vocabulary where the model axis splits it, ``[B, S, V/m]``;
    with ``seq`` from the rank's rows, normed and then gathered
    (``layers.vocab_logits``)."""
    h = _norm(h, params["final_norm"], cfg, seq)
    tied = cfg.tie_embeddings
    return vocab_logits(params, h, cfg, name="embed" if tied else "lm_head",
                        tied=tied, seq=seq)


# -----------------------------------------------------------------------------
# forward (training / prefill without cache)
# -----------------------------------------------------------------------------


def _forward(params: dict, batch: dict, cfg: ModelConfig
             ) -> tuple[torch.Tensor, torch.Tensor | float]:
    """-> (logits ``[B, S, V]``, the auxiliary loss summed over the layers),
    the JAX ``forward``.  With grad enabled each block runs as
    ``layers.remat_block`` runs it under ``cfg.remat``: ``"full"`` under
    ``torch.utils.checkpoint`` (its activations recomputed in the backward
    pass, as under ``jax.checkpoint``), ``"dots"`` under a selective
    checkpoint that saves the outputs of the block's products without
    batch dimensions -- the q, k, v, ``wo`` and FFN projections, the MoE
    router and shared experts, not the attention's or the experts'
    batched products -- as JAX's ``checkpoint_dots_with_no_batch_dims``."""
    seq = _seq_split(batch)
    h = _embed_inputs(params, batch, cfg, seq)
    b, s = h.shape[0], _seq_len(batch)
    cos, sin = _rope_tables(cfg, _positions(batch, cfg, s, b, h.device))
    aux = 0.0
    for p in unbind_layers(params):
        h, a = remat_block(cfg.remat, _block, p, h, cfg, cos, sin, seq,
                           save_products=True)
        aux = aux + a
    return _logits(params, h, cfg, seq), aux


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
    labels = batch["labels"]
    logits = logits[:, -labels.shape[1]:].float()
    loss = next_token_loss(logits, labels, cfg)
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
    last position's logits ``[B, 1, V]`` and the cache at length ``S``.
    With the sequence split (the ``sequence_parallel`` hint) each rank
    runs its rows, the cache filled from the gathered keys and values;
    the last row, the last rank's, reaches every rank by an all-gather of
    each rank's last row (``B x D`` a rank)."""
    seq = _seq_split(batch)
    h = _embed_inputs(params, batch, cfg, seq)
    b, s = h.shape[0], _seq_len(batch)
    cos, sin = _rope_tables(cfg, _positions(batch, cfg, s, b, h.device))
    for i, p in enumerate(unbind_layers(params)):
        p = _layer(p)
        h = h + attention_block(p, _norm(h, p["attn_norm"], cfg, seq), cfg,
                                cos, sin, fill=(cache.k[i], cache.v[i]),
                                seq=seq)
        h = h + _ffn(p, _norm(h, p["mlp_norm"], cfg, seq), cfg, seq)[0]
    last = h[:, -1:]
    if seq:
        last = C.all_gather(last, 1, compute_axes().seq_group)[:, -1:]
    logits = _logits(params, last, cfg)
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
    h = embed_tokens(params, tokens, cfg)
    if extra_embeds is not None:
        h = h + extra_embeds.to(compute)
    b, s, _ = h.shape
    tp = compute_axes()
    s_max = cache.k.shape[2] * (tp.model_size if tp is not None
                                and tp.cache_split("k") else 1)
    if cache.length + s > s_max:
        raise RuntimeError(f"KV cache full: length {cache.length} + {s} > "
                           f"{s_max}")
    pos = torch.full((b, s), cache.length, device=h.device)
    if cfg.mrope_sections is not None:
        pos = pos[None].expand(3, b, s)
    cos, sin = _rope_tables(cfg, pos)
    for i, p in enumerate(unbind_layers(params)):
        h, _ = _block(p, h, cfg, cos, sin,
                      cache=(cache.k[i], cache.v[i], cache.length))
    logits = _logits(params, h, cfg)
    return logits, KVCache(k=cache.k, v=cache.v, length=cache.length + s)
