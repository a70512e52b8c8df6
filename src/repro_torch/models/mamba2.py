"""Mamba-2 (SSD) mixer layer [arXiv:2405.21060], chunked scan formulation.

The port of the JAX package's ``models/mamba2.py``.  Layer: in_proj ->
(z gate | x | B | C | dt) -> causal depthwise conv over (x, B, C) -> SSD
recurrence -> gated RMS norm -> out_proj.

SSD with a scalar decay A per head and shared (one group) B/C:

    h_t = exp(dt_t A) h_{t-1} + dt_t * (B_t outer x_t)      h: [P, N]
    y_t = C_t . h_t + D x_t

computed chunk-parallel in float32: within a chunk of length Q the output
splits into an intra-chunk term (a masked [Q, Q] decay-weighted product)
and an inter-chunk term from the carried state; the state is carried across
chunks by a Python loop where the JAX package scans.  JAX computes all of
this with plain array ops and no Pallas kernel, so the port keeps it as
torch ops (``einsum`` for the products).

Shapes: x [B, S, H, P] (H = d_inner / headdim P), B/C [B, S, N], dt
[B, S, H], A [H].  Parameters keep the JAX names and layouts (``[d_in,
d_out]`` projections; ``A_log``, ``D``, ``dt_bias`` and ``norm_scale`` in
float32).  The SSD's chunks run under ``torch.utils.checkpoint`` where
``cfg.remat`` recomputes blocks (``"full"`` or ``"dots"``); the JAX body
checkpoints them under every policy.

Tensor-parallel compute.  In a rank's partitioned step
(``sharding.api.compute_axes()``) the layer runs the rank's heads (``H /
m``; ``out_proj``'s row block and the SSM state's block are theirs).
``in_proj``'s and ``conv_w``'s contiguous blocks cross the ``z | x | B |
C | dt`` sections, so each is gathered over the model axis and re-laid to
the rank's runs (``_rank_layout``: its ``z`` and ``x`` columns, all of
``B`` and ``C``, its ``dt``) -- ``in_proj``'s product rather than the
weight where the tokens are fewer than ``d_model`` (``_in_proj``) --, the
conv tail read from and written back to the rank's block of the cache's;
the gated RMS norm over ``d_inner`` sums its squares over the model axis,
and ``out_proj``'s partial products are summed by one all-reduce.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.meta import checkpoint_repeated, loop_repeats, repeated
from repro_torch.models.layers import (init_linear, model_slice,
                                       model_whole, remat_checkpoints,
                                       rms_norm)
from repro_torch.sharding import collectives
from repro_torch.sharding.api import compute_axes

__all__ = ["Mamba2State", "mamba2_shapes", "init_mamba2", "ssd_chunked",
           "mamba2_forward", "mamba2_decode_step"]


@dataclasses.dataclass
class Mamba2State:
    ssm: torch.Tensor     # [B, H, P, N] float32
    conv: torch.Tensor    # [B, K-1, conv_channels]


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    d_inner = cfg.d_model * cfg.ssm_expand
    nheads = d_inner // cfg.ssm_headdim
    return d_inner, nheads, cfg.ssm_headdim, cfg.ssm_state


def mamba2_shapes(cfg: ModelConfig, lead: tuple[int, ...] = ()) -> dict:
    """The layer's parameter shapes, with ``lead`` axes prepended."""
    d = cfg.d_model
    d_inner, nheads, _, n = _dims(cfg)
    conv_ch = d_inner + 2 * n
    return {"in_proj": (*lead, d, 2 * d_inner + 2 * n + nheads),
            "conv_w": (*lead, cfg.ssm_conv, conv_ch),
            "conv_b": (*lead, conv_ch),
            "A_log": (*lead, nheads), "D": (*lead, nheads),
            "dt_bias": (*lead, nheads), "norm_scale": (*lead, d_inner),
            "out_proj": (*lead, d_inner, d)}


def init_mamba2(generator: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype, *, device: "torch.device | str" = "cpu",
                lead: tuple[int, ...] = ()) -> dict:
    """Random layer parameters with the JAX package's recipe: projections
    ``normal / sqrt(d_in)``, ``conv_w`` ``normal / K``, ``conv_b`` zero (all
    in ``dtype``); ``A_log = log(linspace(1, 16, H))``, ``D`` one,
    ``dt_bias`` zero and ``norm_scale`` one, in float32."""
    d = cfg.d_model
    d_inner, nheads, _, n = _dims(cfg)
    conv_ch = d_inner + 2 * n

    def f32(values: torch.Tensor) -> torch.Tensor:
        return values.to(device).expand(*lead, -1).contiguous()

    return {
        "in_proj": init_linear(generator, d, 2 * d_inner + 2 * n + nheads,
                               dtype=dtype, device=device, lead=lead),
        "conv_w": init_linear(generator, cfg.ssm_conv, conv_ch, dtype=dtype,
                              scale=1.0 / cfg.ssm_conv, device=device,
                              lead=lead),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dtype, device=device),
        "A_log": f32(torch.log(torch.linspace(1.0, 16.0, nheads))),
        "D": f32(torch.ones(nheads)),
        "dt_bias": f32(torch.zeros(nheads)),
        "norm_scale": f32(torch.ones(d_inner)),
        "out_proj": init_linear(generator, d_inner, d, dtype=dtype,
                                device=device, lead=lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d, then SiLU.  x ``[B, S, C]``, w ``[K, C]``,
    ``prev`` the last ``K-1`` inputs before ``x`` (zeros when None).
    Returns (y, the new tail of ``K-1`` inputs).  The taps are summed in
    the JAX order, tap 0 first."""
    k = w.shape[0]
    s = x.shape[1]
    if prev is None:
        prev = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    tail = xp[:, xp.shape[1] - (k - 1):]
    return F.silu(y + b), tail


def _ssd_chunk(hprev: torch.Tensor, xb: torch.Tensor, dtb: torch.Tensor,
               Bb: torch.Tensor, Cb: torch.Tensor, A: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk: (the state after it, its output ``[B, q, H, P]``), both
    float32."""
    q = xb.shape[1]
    a = dtb * A                                          # [B, q, H]
    cum = torch.cumsum(a, dim=1)
    # Mask the EXPONENT before exp: the upper triangle's exponents are
    # positive and overflow to inf, and a mask after exp would put inf * 0
    # into the backward pass.
    expo = cum[:, :, None, :] - cum[:, None, :, :]       # [B, q, q, H]
    upper = ~torch.ones((q, q), dtype=torch.bool, device=xb.device).tril()
    L = torch.exp(expo.masked_fill(upper[None, :, :, None], float("-inf")))
    x32, B32, C32 = xb.float(), Bb.float(), Cb.float()
    CB = torch.einsum("bqn,bsn->bqs", C32, B32)           # [B, q, q]
    scores = CB[..., None] * L * dtb[:, None, :, :]      # [B, q, s, H]
    y = torch.einsum("bqsh,bshp->bqhp", scores, x32)
    # inter-chunk: the incoming state
    y = y + torch.einsum("bqn,bhpn->bqhp", C32, hprev) \
        * torch.exp(cum)[..., None]
    # the state after the chunk
    decay_end = torch.exp(cum[:, -1:, :] - cum)          # [B, q, H]
    dB = (decay_end * dtb)[..., None] * B32[:, :, None, :]   # [B, q, H, N]
    hnew = (torch.exp(cum[:, -1])[:, :, None, None] * hprev
            + torch.einsum("bqhn,bqhp->bhpn", dB, x32))
    return hnew, y


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, A: torch.Tensor, D: torch.Tensor, *,
                chunk: int = 128, h0: torch.Tensor | None = None,
                remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel SSD.  x ``[B, S, H, P]``, dt ``[B, S, H]`` (float32),
    B/C ``[B, S, N]``, A/D ``[H]``; ``h0`` ``[B, H, P, N]`` float32 (zeros
    when None).  ``S`` must be a multiple of ``min(chunk, S)``, as the JAX
    function asserts.  With ``remat`` and grad enabled each chunk runs
    under ``torch.utils.checkpoint`` (as the JAX body's ``jax.checkpoint``).

    Returns (y ``[B, S, H, P]`` in x's dtype, the final state float32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    assert s % q == 0, (s, q)
    hcur = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
            if h0 is None else h0.float())
    remat = remat and torch.is_grad_enabled()
    ys, hold = [], []
    # on the meta device a representative chunk stands for the middle ones
    # (``repro_torch.meta.loop_repeats``); under remat a skipped chunk
    # leaves the state it would have saved in ``hold``
    reps = loop_repeats(s // q, x, checkpointed=remat)
    for c0, n_rep in zip(range(0, s, q), reps):
        if not n_rep:
            ys.append(torch.empty_like(ys[-1]))
            if remat:
                hold.append(torch.empty_like(hcur))
            continue
        args = (hcur, x[:, c0:c0 + q], dt[:, c0:c0 + q], B[:, c0:c0 + q],
                C[:, c0:c0 + q], A)
        if remat and n_rep > 1:
            hcur, y = checkpoint_repeated(n_rep, _ssd_chunk, args, hold)
            hold = []
        elif remat:
            hcur, y = checkpoint(_ssd_chunk, *args, use_reentrant=False)
        else:
            with repeated(n_rep):
                hcur, y = _ssd_chunk(*args)
        ys.append(y)
    y = torch.cat(ys, dim=1) + D[:, None] * x.float()
    return y.to(x.dtype), hcur


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, n: int):
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt


def _runs(parts, dim: int, t: torch.Tensor) -> torch.Tensor:
    """The ``(start, length)`` runs of ``t`` along ``dim``, in order."""
    return torch.cat([t.narrow(dim, a, n) for a, n in parts], dim)


def _rank_layout(cfg: ModelConfig, tp) -> tuple:
    """The rank's runs of ``in_proj``'s columns (its ``z`` and ``x``
    columns, all of ``B`` and ``C``, its ``dt``) and of the conv's
    channels (its ``x`` channels, ``B`` and ``C``): its heads' share of
    the layer, which ``param_specs``' contiguous blocks of both leaves
    cross."""
    d_inner, nheads, _, n = _dims(cfg)
    m, r = tp.model_size, tp.model_rank
    dl, hl = d_inner // m, nheads // m
    cols = ((r * dl, dl), (d_inner + r * dl, dl), (2 * d_inner, 2 * n),
            (2 * d_inner + 2 * n + r * hl, hl))
    chans = ((r * dl, dl), (d_inner, 2 * n))
    return cols, chans


def _rank_params(params: dict, cfg: ModelConfig):
    """The layer's leaves as this rank computes with them, and its axes
    (``None`` outside a partitioned step or at a model axis of one rank,
    where the leaves are the whole layer's).  In a partitioned step the
    rank runs its heads (``H / m``): ``conv_w`` is gathered whole over the
    model axis and re-laid to the rank's runs (``_rank_layout``; the
    backward pass reduce-scatters its partial gradients), ``conv_b`` and
    the per-head leaves cut to them; ``in_proj`` stays the rank's block
    (``_in_proj`` re-lays it or its product); ``out_proj``'s row block is
    the rank's heads already."""
    tp = compute_axes()
    if tp is None or tp.model_size == 1:
        return params, None
    d_inner, nheads, _, _ = _dims(cfg)
    if nheads % tp.model_size:
        raise NotImplementedError(
            f"mamba2: {nheads} heads do not divide the model axis "
            f"({tp.model_size}); the partitioned layer runs whole heads")
    _, chans = _rank_layout(cfg, tp)
    out = dict(params)
    out["conv_w"] = _runs(chans, -1, model_whole(params["conv_w"], tp,
                                                 ("mamba", "conv_w")))
    out["conv_b"] = _runs(chans, -1, collectives.copy_to(
        params["conv_b"], tp.model_group))
    for name in ("A_log", "D", "dt_bias", "norm_scale"):
        out[name] = model_slice(params[name], -1, tp)
    return out, tp


def _rank_conv(conv: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """The rank's channels (``_rank_layout``) of the conv tail from its
    block of the cache's (all the channels where the spec leaves them
    whole)."""
    if tp.cache_split("ssm/conv"):
        conv = collectives.all_gather(conv, -1, tp.model_group)
    return _runs(_rank_layout(cfg, tp)[1], -1, conv)


def _conv_block(tail: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """The rank's block of the cache's new conv tail from the tail of its
    own channels: the ranks' ``x`` channels gathered beside ``B`` and
    ``C``, then its block where the spec splits the channels."""
    d_inner, _, _, _ = _dims(cfg)
    dl = d_inner // tp.model_size
    xs = collectives.all_gather(tail[..., :dl], -1, tp.model_group)
    whole = torch.cat([xs, tail[..., dl:]], -1)
    if not tp.cache_split("ssm/conv"):
        return whole
    n = whole.shape[-1] // tp.model_size
    return whole.narrow(-1, tp.model_rank * n, n)


def _in_proj(h: torch.Tensor, w: torch.Tensor, cfg: ModelConfig, tp
             ) -> torch.Tensor:
    """``h @ in_proj`` at the rank's runs (``_rank_layout``) from its block
    ``w`` of ``in_proj``'s columns: with fewer tokens than ``d_model``
    rows (a decode step) the ranks' products are gathered and re-laid --
    ``tokens x cols`` moved where the weight is ``d_model x cols`` --,
    else the weight is gathered whole and re-laid.  Either gather's
    backward pass reduce-scatters the partial gradients (the ``B`` / ``C``
    columns feed every rank's heads)."""
    cols, _ = _rank_layout(cfg, tp)
    plan = tp.plan(("mamba", "in_proj"))
    if plan is not None and plan.model_dim is not None \
            and h[..., 0].numel() < w.shape[0]:
        return _runs(cols, -1, collectives.gather_summed(
            h @ w, -1, tp.model_group))
    return h @ _runs(cols, -1, model_whole(w, tp, ("mamba", "in_proj")))


def _project(params: dict, h: torch.Tensor, cfg: ModelConfig,
             state: "Mamba2State | None"):
    """in_proj and the causal conv: ``(z, x, B, C, dt_raw, conv tail,
    params, tp)`` for the rank's heads (every head outside a partitioned
    step); ``h`` enters as Megatron's ``f`` in one."""
    params, tp = _rank_params(params, cfg)
    _, _, _, n = _dims(cfg)
    d_inner = params["norm_scale"].shape[-1]
    prev = None if state is None else state.conv
    if tp is None:
        zxbcdt = h @ params["in_proj"]
    else:
        h = collectives.copy_to(h, tp.model_group)
        zxbcdt = _in_proj(h, params["in_proj"], cfg, tp)
        if prev is not None:
            prev = _rank_conv(prev, cfg, tp)
    z, xbc, dt_raw = _split_proj(zxbcdt, d_inner, n)
    xbc, conv_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                  prev)
    return (z, xbc[..., :d_inner], xbc[..., d_inner:d_inner + n],
            xbc[..., d_inner + n:], dt_raw, conv_tail, params, tp)


def _output(y: torch.Tensor, z: torch.Tensor, params: dict, tp
            ) -> torch.Tensor:
    """The gated RMS norm over ``d_inner`` (its sum of squares summed over
    the model axis in a partitioned step) and the row-parallel
    ``out_proj``."""
    group = None if tp is None else tp.model_group
    y = rms_norm(y * F.silu(z), params["norm_scale"], group=group)
    out = y @ params["out_proj"]
    return out if tp is None else collectives.reduce_from(out, group)


def mamba2_forward(params: dict, h: torch.Tensor, cfg: ModelConfig, *,
                   state: Mamba2State | None = None, chunk: int = 128
                   ) -> tuple[torch.Tensor, Mamba2State]:
    """Full-sequence mixer.  h ``[B, S, D]`` -> (out ``[B, S, D]``, the
    final state), from ``state`` (zeros when None).  In a partitioned step
    the state is the rank's block of the cache's (its heads' SSM state,
    its block of the conv tail)."""
    b, s, _ = h.shape
    _, _, p_dim, _ = _dims(cfg)
    z, x, B, C, dt_raw, conv_tail, params, tp = _project(params, h, cfg,
                                                          state)
    d_inner = x.shape[-1]
    x = x.reshape(b, s, d_inner // p_dim, p_dim)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, hfinal = ssd_chunked(x, dt, B, C, A, params["D"], chunk=min(chunk, s),
                            h0=state.ssm if state is not None else None,
                            remat=remat_checkpoints(cfg.remat))
    out = _output(y.reshape(b, s, d_inner), z, params, tp)
    if tp is not None and state is not None:
        conv_tail = _conv_block(conv_tail, cfg, tp)
    return out, Mamba2State(ssm=hfinal, conv=conv_tail)


def mamba2_decode_step(params: dict, h: torch.Tensor, cfg: ModelConfig,
                       state: Mamba2State) -> tuple[torch.Tensor, Mamba2State]:
    """Single-token step.  h ``[B, 1, D]`` -> (out ``[B, 1, D]``, the state
    one step on); the state as in ``mamba2_forward``."""
    b, s, _ = h.shape
    assert s == 1, s
    _, _, p_dim, _ = _dims(cfg)
    z, x, B, C, dt_raw, conv_tail, params, tp = _project(params, h, cfg,
                                                          state)
    d_inner = x.shape[-1]
    x32 = x.reshape(b, d_inner // p_dim, p_dim).float()
    B, C = B[:, 0].float(), C[:, 0].float()
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])   # [B, H]
    decay = torch.exp(dt * -torch.exp(params["A_log"]))
    hnew = (decay[:, :, None, None] * state.ssm
            + (dt[..., None, None] * x32[..., None]) * B[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", C, hnew) + params["D"][:, None] * x32
    y = y.reshape(b, 1, d_inner).to(h.dtype)
    out = _output(y, z, params, tp)
    if tp is not None:
        conv_tail = _conv_block(conv_tail, cfg, tp)
    return out, Mamba2State(ssm=hnew, conv=conv_tail)
