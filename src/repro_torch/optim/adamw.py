"""AdamW with decoupled weight decay and global-norm clipping.

The port of the JAX package's ``optim/adamw.py``: state = ``{m, v,
count}``, m and v in float32 whatever the parameters' dtype, ``count`` an
int32 tensor on the device.  The update keeps the JAX op order: the
global gradient norm over the leaves in the JAX leaf order, the clip
factor, bias corrections computed in float32 from the int ``count``,
decoupled decay on matrices only (``ndim >= 2``), the cast back to each
parameter's dtype.

Where the JAX step donates its parameter and optimizer buffers
(``donate_argnums``), ``adamw_update`` writes the new parameters, m and v
into the tensors it is given: at the published widths that saves a second
copy of the float32 moments (13.8 GB for qwen3-1.7b).  It updates a
leaf in flat blocks of ``UPDATE_BLOCK`` elements, so its float32
temporaries stay at most three blocks (three of qwen2-vl-72b's
embedding leaf whole would be 15 GB), and the global norm squares one
float32 copy of a leaf at a time.  A caller that still needs the old
values passes copies.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_items, tree_leaves, tree_map

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "global_norm"]

# the elements of a leaf updated at once (256 MB a float32 temporary)
UPDATE_BLOCK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params: Any, *,
                   device: "str | torch.device | None" = None) -> dict:
    """Zero moments (float32, one per parameter leaf) and ``count`` 0
    (int32) on ``device`` (default ``"cuda"``), where the parameters must
    lie; without a CUDA device the default raises ``RuntimeError``."""
    dev = resolve_device(device)
    for key, p in tree_items(params):
        if p.device.type != dev.type or (
                dev.index is not None and p.device.index != dev.index):
            raise ValueError(f"init_opt_state: parameter {key} lies on "
                             f"{p.device}, the state on {dev}")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(leaves: list) -> torch.Tensor:
    """The clip's norm: the root of the sum of every leaf's float32
    squares, leaf by leaf in the order given."""
    total = None
    for x in leaves:
        # one float32 copy squared in place (the same bits as square of
        # float, without its second leaf-sized temporary)
        s = x.to(torch.float32, copy=True).square_().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def _f32(x: float, dev) -> torch.Tensor:
    """A float32 0-d tensor on ``dev``: dividing by it stays an IEEE
    division on the card (a host scalar divisor becomes a multiplication
    by its reciprocal there).  Filled on the device: a copy from the host
    would wait for the stream's queued work."""
    return torch.full((), x, dtype=torch.float32, device=dev)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: dict,
                 *, gnorm: "torch.Tensor | None" = None
                 ) -> tuple[Any, dict]:
    """One AdamW step.  Writes the new parameters into ``params``' tensors
    and the new moments into ``state["m"]`` / ``state["v"]``, and returns
    ``(params, {"m", "v", "count": count + 1})`` over those same
    tensors.  ``gnorm`` is the clip's norm when the caller has it: a
    sharded step updates its blocks of the leaves, clipped by the norm of
    the whole gradient."""
    count_old = state["count"]
    dev = count_old.device
    count = count_old + 1
    if gnorm is None:
        gnorm = global_norm(tree_leaves(grads))
    scale = torch.clamp(_f32(cfg.grad_clip, dev)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    warm = torch.clamp((count_old + 1).float()
                       / _f32(max(cfg.warmup_steps, 1), dev), max=1.0)
    lr = cfg.learning_rate * warm
    cnt = count.float()
    bc1 = 1 - torch.pow(_f32(cfg.b1, dev), cnt)
    bc2 = 1 - torch.pow(_f32(cfg.b2, dev), cnt)

    def upd_block(p, g, m, v, decay):
        # the JAX expressions, evaluated in place where an operand is not
        # read again (the same elementwise ops, so the same bits)
        g32 = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_(g32.square_().mul_(1 - cfg.b2))
        del g32
        step = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if decay:
            step.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - step.mul_(lr))

    def upd(p, g, m, v):
        # decoupled weight decay on matrices only (ndim >= 2)
        decay = p.dim() >= 2
        if not all(t.is_contiguous() for t in (p, g, m, v)):
            upd_block(p, g, m, v, decay)
            return
        # elementwise, so a leaf runs in flat blocks: at most three
        # float32 temporaries of UPDATE_BLOCK elements live at once
        p, g, m, v = (t.view(-1) for t in (p, g, m, v))
        for i in range(0, p.numel(), UPDATE_BLOCK):
            j = i + UPDATE_BLOCK
            upd_block(p[i:j], g[i:j], m[i:j], v[i:j], decay)

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "count": count}
