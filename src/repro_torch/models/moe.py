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

In a partitioned step (``sharding.api.compute_axes()``) the tokens are
replicated over the model axis: every rank routes and dispatches alike.
Under ``moe_parallel="ep"`` (the configs' setting) a rank holds ``E/m``
experts and runs them on its slice of the dispatch buffer, under ``"tp"``
the rank's ``F/m`` slice of every expert; the shared experts run column-
into row-parallel.  The combine's partial sums, the shared experts'
added, are summed over the model axis by one all-reduce.  The tokens and
the gates enter that part as Megatron's ``f`` (their gradients summed
over the axis).

Under the ``sequence_parallel`` hint a rank holds its rows of the
sequence.  The experts' part gathers them (``gather_summed`` in the
tokens' ``copy_to``'s place) and reduce-scatters the partial sums back
to the rank's rows in the all-reduce's place; the router, the capacity
and the auxiliary loss see every row, as without the hint.  The router's
input gradient, whole and alike on every rank, joins the gather's
backward sum once (``collectives.counted_once``).  Experts that the
specs leave whole run alike over the gathered rows on every rank, and
the rank keeps its rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (init_linear, seq_rows, seq_weight,
                                       swiglu)
from repro_torch.sharding import collectives as C
from repro_torch.sharding.api import compute_axes

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


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
            seq: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, d] -> (y [B, S, d], aux)``: the routed experts' output
    (plus the shared experts') and the float32 Switch auxiliary loss.
    With ``seq`` (the ``sequence_parallel`` hint) ``x`` and ``y`` are the
    rank's rows of a split sequence: the router, the dispatch's capacity
    and the auxiliary loss still see every row (see the module
    docstring)."""
    tp = compute_axes()
    split, shared_group = None, None
    if tp is not None:
        params, split, shared_group = _partition(params, cfg, tp,
                                                 seq=seq)
    if seq and split is None:
        # every rank runs the whole FFN alike over the gathered rows
        alike = tp.model_group is not None
        gather = C.gather_from if alike else C.gather_summed
        y, aux = _moe(params, gather(x, 1, tp.seq_group), cfg, tp, None,
                      shared_group)
        return seq_rows(y, tp), aux
    return _moe(params, x, cfg, tp, split, shared_group, seq=seq)


def _moe(params: dict, x: torch.Tensor, cfg: ModelConfig, tp, split,
         shared_group, *, seq: bool = False
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` on leaves ``_partition`` has placed: over the rank's
    experts (``split``) and the model axis's group, or unpartitioned.
    With ``seq`` (``split`` given) ``x`` holds the rank's rows: gathered
    (``gather_summed``, in the place of the experts' ``copy_to``), the
    router's input counted once in that gather's backward sum
    (``counted_once``: every rank routes alike), the shared experts
    column-parallel on the gathered rows (or, whole, on the rank's own),
    and the partial sums reduce-scattered back to the rank's rows."""
    group = tp.model_group if split else None
    own = x
    xr = x
    if seq:
        x = C.gather_summed(x, 1, group)
        xr = C.counted_once(x, group)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_token
    cap = capacity(s, cfg)

    probs, gates, experts = route(params, xr, cfg)

    frac = F.one_hot(experts, e).float().mean((1, 2))           # [B, E]
    aux = e * (frac * probs.mean(1)).sum(-1).mean()

    order, slot, keep = dispatch(experts, e, cap)               # [B, S*k]
    sorted_tok = torch.div(order, k, rounding_mode="floor")
    sorted_g = gates.reshape(b, s * k).gather(-1, order)
    xe = x
    if group is not None:
        sorted_g = C.copy_to(sorted_g, group)
        if not seq:
            xe = C.copy_to(x, group)
    if split == "ep":
        # the rank's experts: its slots, the others' to the sentinel
        el = params["w_gate"].shape[0]
        lo = tp.model_rank * el * cap
        mine = (slot >= lo) & (slot < lo + el * cap)
        slot = torch.where(mine, slot - lo, torch.full_like(slot, el * cap))
        e = el

    xg = xe.gather(1, sorted_tok[..., None].expand(b, s * k, d))
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

    ys = None
    if cfg.num_shared_experts:
        sh = params["shared"]
        if seq and shared_group is not None:     # its partial sums join y's
            y = y + swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"])
        elif seq:                                # whole: on the rank's rows
            ys = swiglu(own, sh["w_gate"], sh["w_up"], sh["w_down"])
        else:
            ys = swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"],
                        group=shared_group, reduce=group is None)
            if group is None or shared_group is not None:
                y, ys = y + ys, None
    if group is not None:
        y = C.scatter_from(y, 1, group) if seq else C.reduce_from(y, group)
    if ys is not None:
        y = y + ys
    return y, aux.float()


_EXPERTS = ("w_gate", "w_up", "w_down")
# the model-axis dim of an expert leaf ([E, d, f] / [E, f, d]) per mode
_SPLIT_DIM = {"ep": {"w_gate": 0, "w_up": 0, "w_down": 0},
              "tp": {"w_gate": 2, "w_up": 2, "w_down": 1}}


def _partition(params: dict, cfg: ModelConfig, tp, *, seq: bool = False
               ) -> tuple:
    """A rank's MoE leaves (their FSDP blocks already gathered by the
    layer) as it computes on them: the mode whose split the specs give the
    experts (``"ep"`` / ``"tp"``), else ``None`` with the experts gathered
    whole over the model axis; the shared experts' model group where the
    specs split them, else ``None`` with them gathered whole -- under
    ``seq`` with the experts split, whole through ``layers.seq_weight``
    (they then run on the rank's rows alone)."""
    pre = ("layers", "moe")

    def whole(tree, prefix, names):
        tree = dict(tree)
        for n in names:
            plan = tp.plan(prefix + (n,))
            if plan.model_dim is not None:
                tree[n] = C.gather_from(tree[n], plan.model_dim,
                                        tp.model_group)
        return tree

    dims = {n: tp.plan(pre + (n,)).model_dim for n in _EXPERTS}
    split = cfg.moe_parallel if dims == _SPLIT_DIM[cfg.moe_parallel] \
        else None
    if split is None:
        params = whole(params, pre, _EXPERTS)
    shared = None
    if cfg.num_shared_experts:
        sp = pre + ("shared",)
        if all(tp.plan(sp + (n,)).model_dim is not None for n in _EXPERTS):
            shared = tp.model_group
        elif seq and split is not None:
            params = dict(params, shared={
                n: seq_weight(w, tp, sp + (n,))
                for n, w in params["shared"].items()})
        else:
            params = dict(params, shared=whole(params["shared"], sp,
                                               _EXPERTS))
    return params, split, shared
