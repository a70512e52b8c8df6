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
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.meta import checkpoint_repeated, loop_repeats, repeated
from repro_torch.models.layers import (init_linear, remat_checkpoints,
                                       rms_norm)

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


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_inner, _, _, n = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt


def mamba2_forward(params: dict, h: torch.Tensor, cfg: ModelConfig, *,
                   state: Mamba2State | None = None, chunk: int = 128
                   ) -> tuple[torch.Tensor, Mamba2State]:
    """Full-sequence mixer.  h ``[B, S, D]`` -> (out ``[B, S, D]``, the
    final state), from ``state`` (zeros when None)."""
    b, s, _ = h.shape
    d_inner, nheads, p_dim, n = _dims(cfg)
    z, xbc, dt_raw = _split_proj(h @ params["in_proj"], cfg)
    xbc, conv_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                  state.conv if state is not None else None)
    x = xbc[..., :d_inner].reshape(b, s, nheads, p_dim)
    B = xbc[..., d_inner:d_inner + n]
    C = xbc[..., d_inner + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, hfinal = ssd_chunked(x, dt, B, C, A, params["D"], chunk=min(chunk, s),
                            h0=state.ssm if state is not None else None,
                            remat=remat_checkpoints(cfg.remat))
    y = rms_norm(y.reshape(b, s, d_inner) * F.silu(z), params["norm_scale"])
    return y @ params["out_proj"], Mamba2State(ssm=hfinal, conv=conv_tail)


def mamba2_decode_step(params: dict, h: torch.Tensor, cfg: ModelConfig,
                       state: Mamba2State) -> tuple[torch.Tensor, Mamba2State]:
    """Single-token step.  h ``[B, 1, D]`` -> (out ``[B, 1, D]``, the state
    one step on)."""
    b, s, _ = h.shape
    assert s == 1, s
    d_inner, nheads, p_dim, n = _dims(cfg)
    z, xbc, dt_raw = _split_proj(h @ params["in_proj"], cfg)
    xbc, conv_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                  state.conv)
    x32 = xbc[..., :d_inner].reshape(b, nheads, p_dim).float()
    B = xbc[:, 0, d_inner:d_inner + n].float()
    C = xbc[:, 0, d_inner + n:].float()
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])   # [B, H]
    decay = torch.exp(dt * -torch.exp(params["A_log"]))
    hnew = (decay[:, :, None, None] * state.ssm
            + (dt[..., None, None] * x32[..., None]) * B[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", C, hnew) + params["D"][:, None] * x32
    y = y.reshape(b, 1, d_inner).to(h.dtype)
    y = rms_norm(y * F.silu(z), params["norm_scale"])
    return y @ params["out_proj"], Mamba2State(ssm=hnew, conv=conv_tail)
