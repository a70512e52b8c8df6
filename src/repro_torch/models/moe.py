"""Mixture-of-Experts FFN with capacity-bounded sort dispatch.

The port of the JAX package's ``models/moe.py``, step for step, as plain
functions on tensors:

  1. route: the router in float32 (``x.float() @ router``; TF32 stays off,
     it would move the routing), softmax, top-k, the gates renormalised
     over the top-k with a 1e-9 floor;
  2. the Switch auxiliary loss, ``E * mean_b sum_e (fraction routed to e *
     mean prob of e)``;
  3. per batch row, a stable sort of the ``S*k`` (token, expert)
     assignments by expert id, each assignment's rank within its expert's
     run (a batched ``searchsorted`` for the run starts), and the slots
     past the capacity ``C = int(S * k * capacity_factor / E) + 1``
     dropped to a sentinel row (earlier tokens win, as the sort is stable);
  4. the tokens scattered into an ``[B, E*C + 1, d]`` buffer (kept slots
     are unique, so nothing accumulates; the sentinel row is discarded),
     every expert's SwiGLU as one batched product over ``E``, the results
     gathered back and weighted by ``gate * keep``;
  5. the combine without atomics: each token's ``k`` contributions reach
     it through the inverse of the sort and are summed by one reduction
     over the ``k`` (a fixed-order reduction on the card, no atomics), so
     two runs on the card give the same bits; then the shared experts'
     SwiGLU is added.

The expert weights are ``[E, d, f]`` / ``[E, f, d]``; the router ``[d, E]``
stays float32 whatever the parameter dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import init_linear, swiglu

__all__ = ["init_moe", "moe_ffn", "moe_shapes", "route", "capacity",
           "dispatch"]


def moe_shapes(cfg: ModelConfig, lead: tuple[int, ...] = ()) -> dict:
    """The MoE parameter tree's shapes (tuples), with ``lead`` prepended:
    ``router [d, E]`` (float32), ``w_gate``/``w_up [E, d, f]``, ``w_down
    [E, f, d]`` and, with shared experts, ``shared/{w_gate, w_up [d, fs],
    w_down [fs, d]}`` of width ``fs = d_ff * num_shared_experts``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    shapes = {"router": (*lead, d, e), "w_gate": (*lead, e, d, f),
              "w_up": (*lead, e, d, f), "w_down": (*lead, e, f, d)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        shapes["shared"] = {"w_gate": (*lead, d, fs), "w_up": (*lead, d, fs),
                            "w_down": (*lead, fs, d)}
    return shapes


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype, *, device: "torch.device | str",
             lead: tuple[int, ...] = ()) -> dict:
    """Random MoE parameters with the JAX package's recipe: a float32
    router at scale ``1/sqrt(d)``; each expert matrix one draw of
    ``normal / sqrt(d_in)`` in ``dtype``, broadcast over the ``E`` experts,
    plus ``0.02 * normal`` noise per expert (cast to ``dtype`` and added
    there, as in JAX); the shared experts as ordinary linears.  ``lead``
    prepends axes (``(L,)`` for a stack of layers).

    Every leaf is allocated once and filled one ``[d_in, d_out]`` matrix at
    a time, so the float32 temporaries stay at one expert's matrix and the
    peak is the parameters plus that.  The numbers differ from the JAX
    package's for the same seed."""
    shapes = moe_shapes(cfg, lead)
    d = cfg.d_model
    p = {"router": init_linear(generator, d, cfg.num_experts,
                               dtype=torch.float32, device=device,
                               lead=lead)}
    for name in ("w_gate", "w_up", "w_down"):
        w = torch.empty(shapes[name], dtype=dtype, device=device)
        mats = w.view(-1, *shapes[name][-3:])          # [L*, E, d_in, d_out]
        d_in, d_out = shapes[name][-2:]
        for m in mats:                                  # [E, d_in, d_out]
            base = init_linear(generator, d_in, d_out, dtype=dtype,
                               device=device)
            for i in range(m.shape[0]):
                m[i] = torch.randn((d_in, d_out), generator=generator,
                                   dtype=torch.float32,
                                   device=device).mul_(0.02)
                m[i] += base
        p[name] = w
    if cfg.num_shared_experts:
        p["shared"] = {name: init_linear(generator, *shape[-2:], dtype=dtype,
                                         device=device, lead=lead)
                       for name, shape in shapes["shared"].items()}
    return p


def capacity(s: int, cfg: ModelConfig) -> int:
    """Slots per expert in one batch row of ``s`` tokens: the JAX
    package's ``int(s * k * capacity_factor / E) + 1``, in Python."""
    return int(s * cfg.num_experts_per_token * cfg.capacity_factor
               / cfg.num_experts) + 1


def dispatch(experts: torch.Tensor, num_experts: int, cap: int
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-row sort dispatch of ``experts`` ``[B, S, k]``: ``order``
    (the stable sort of the ``S*k`` flattened assignments by expert id),
    and in sorted order each assignment's ``slot`` in the ``[E*cap + 1]``
    buffer (``E*cap``, the sentinel, where dropped) and ``keep`` (its rank
    within its expert's run is below ``cap``)."""
    b = experts.shape[0]
    flat_e = experts.reshape(b, -1)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(-1, order)
    arange_e = torch.arange(num_experts, device=experts.device,
                            dtype=sorted_e.dtype).expand(b, num_experts)
    seg_start = torch.searchsorted(sorted_e.contiguous(),
                                   arange_e.contiguous(), side="left")
    pos = (torch.arange(flat_e.shape[1], device=experts.device)[None, :]
           - seg_start.gather(-1, sorted_e))
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos,
                       torch.full_like(pos, num_experts * cap))
    return order, slot, keep


def _experts(buf: torch.Tensor, p: dict) -> torch.Tensor:
    """Every expert's SwiGLU on its ``[B, cap, d]`` slots, as batched
    products over ``E``: ``buf [B, E, cap, d] -> [B, E, cap, d]``."""
    b, e, cap, d = buf.shape
    xe = buf.transpose(0, 1).reshape(e, b * cap, d)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"])
    return ye.reshape(e, b, cap, d).transpose(0, 1)


def route(params: dict, x: torch.Tensor, cfg: ModelConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router in float32: ``probs [B, S, E]`` (softmax of
    ``x.float() @ router``), and the top-k ``gates`` (renormalised over the
    k with a 1e-9 floor) and ``experts`` ``[B, S, k]``."""
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    gates, experts = torch.topk(probs, cfg.num_experts_per_token, dim=-1)
    return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), experts


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, d] -> (y [B, S, d], aux)``: the routed experts' output
    (plus the shared experts') and the float32 Switch auxiliary loss."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_token
    cap = capacity(s, cfg)

    probs, gates, experts = route(params, x, cfg)

    frac = F.one_hot(experts, e).float().mean((1, 2))           # [B, E]
    aux = e * (frac * probs.mean(1)).sum(-1).mean()

    order, slot, keep = dispatch(experts, e, cap)               # [B, S*k]
    sorted_tok = torch.div(order, k, rounding_mode="floor")
    sorted_g = gates.reshape(b, s * k).gather(-1, order)

    xg = x.gather(1, sorted_tok[..., None].expand(b, s * k, d))
    buf = x.new_zeros((b, e * cap + 1, d))
    buf.scatter_(1, slot[..., None].expand(b, s * k, d), xg)
    yb = _experts(buf[:, :e * cap].reshape(b, e, cap, d), params)
    yb = torch.cat([yb.reshape(b, e * cap, d), yb.new_zeros((b, 1, d))], 1)

    yg = yb.gather(1, slot[..., None].expand(b, s * k, d))      # sorted
    yg = yg * (sorted_g * keep).to(yg.dtype)[..., None]
    inv = torch.empty_like(order).scatter_(
        -1, order, torch.arange(s * k, device=x.device).expand(b, s * k))
    yk = yg.gather(1, inv[..., None].expand(b, s * k, d)).reshape(b, s, k, d)
    y = yk.sum(2)

    if cfg.num_shared_experts:
        sh = params["shared"]
        y = y + swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"])
    return y, aux.float()
