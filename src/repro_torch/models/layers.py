"""Foundational model layers: norms, activations, RoPE, init helpers.

The port of the JAX package's ``models/layers.py``.  Plain functions on
tensors over parameter dictionaries, with the same conventions:

  * weights are stored for row-major activations: ``y = x @ W`` with
    ``W: [d_in, d_out]`` (the JAX layout, so converted parameters need no
    transpose);
  * per-layer parameters are stacked on a leading ``[L, ...]`` axis;
  * ``param_dtype`` for storage, ``compute_dtype`` for matmuls; norms and
    softmax accumulate in float32.

Every random draw takes an explicit ``torch.Generator``; ``init_linear``
fills a whole ``[L, ...]`` stack in place, so ``stack_layers`` has no use
here.  ``mrope_frequencies`` is the VLM family's multimodal RoPE.

``remat_block`` runs a block as ``cfg.remat`` asks, for every model
family: ``"full"`` under ``torch.utils.checkpoint`` (``jax.checkpoint``
there), ``"dots"`` under a selective checkpoint whose policy
(``dots_policy``) saves the outputs of products without batch dimensions
and recomputes the rest (``checkpoint_dots_with_no_batch_dims`` there)
where the JAX block takes that policy -- the transformer's -- and as
``"full"`` where it takes plain ``jax.checkpoint`` (rwkv6, zamba2 and
enc-dec check ``cfg.remat in ("full", "dots")``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import collectives
from repro_torch.tree import tree_leaves

__all__ = ["rms_norm", "layer_norm", "init_norm", "init_linear", "swiglu",
           "gelu_mlp", "rope", "apply_rope", "mrope_frequencies",
           "mask_padded_vocab", "unbind_layers", "remat_checkpoints",
           "remat_block", "dots_policy", "NEG_INF", "DRAW_BLOCK"]

NEG_INF = -2.3819763e38  # large finite negative, bf16-safe (the JAX value)
DRAW_BLOCK = 1 << 24     # float32 elements ``init_linear`` draws at a time


# -----------------------------------------------------------------------------
# Norms
# -----------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis in float32, cast back to ``x``'s dtype."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis in float32 (biased variance, as
    ``jnp.var``), cast back to ``x``'s dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def init_norm(d: int, *, with_bias: bool = False,
              dtype: torch.dtype = torch.float32,
              device: "torch.device | str" = "cpu") -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if with_bias:
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


# -----------------------------------------------------------------------------
# MLPs
# -----------------------------------------------------------------------------


def init_linear(generator: torch.Generator, d_in: int, d_out: int, *,
                dtype: torch.dtype = torch.float32,
                scale: float | None = None,
                device: "torch.device | str" = "cpu",
                lead: tuple[int, ...] = ()) -> torch.Tensor:
    """``normal * scale`` (default ``1/sqrt(d_in)``) drawn in float32 from
    ``generator`` (which must live on ``device``) and cast to ``dtype``.
    ``lead`` prepends axes, e.g. ``(L,)`` for a stack of layers.

    The result is allocated once in ``dtype`` and drawn a block of rows at
    a time (at most one ``[d_in, d_out]`` slice of ``lead`` and at most
    ``DRAW_BLOCK`` elements), so the float32 temporaries stay at one block
    and the peak is the parameters plus one block."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    out = torch.empty((*lead, d_in, d_out), dtype=dtype, device=device)
    rows = out.view(-1, d_out)
    step = max(1, min(d_in, DRAW_BLOCK // d_out))
    for r in range(0, rows.shape[0], step):
        n = min(step, rows.shape[0] - r)
        rows[r:r + n] = torch.randn((n, d_out), generator=generator,
                                    dtype=torch.float32,
                                    device=device).mul_(scale)
    return out


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, *, group=None,
           reduce: bool = True) -> torch.Tensor:
    """SwiGLU FFN: ``(silu(x W_g) * (x W_u)) W_d``.

    With a model-axis ``group`` the weights are the rank's blocks of a
    column-parallel ``W_g`` / ``W_u`` (``[d, f/m]``) and a row-parallel
    ``W_d`` (``[f/m, d]``): ``x`` enters as Megatron's ``f`` (its gradient
    summed over the group) and the partial products are summed by one
    all-reduce over the group (``reduce=False`` leaves the partial sum to a
    caller that adds it to another before reducing)."""
    if group is not None:
        x = collectives.copy_to(x, group)
    y = (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
    return collectives.reduce_from(y, group) if group is not None \
        and reduce else y


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
             b_up: torch.Tensor | None = None,
             b_down: torch.Tensor | None = None, *,
             group=None) -> torch.Tensor:
    """GELU FFN with the tanh approximation (``jax.nn.gelu``'s default);
    ``group`` as in ``swiglu`` (the up bias is the rank's block of it, the
    down bias is added once, after the reduction)."""
    if group is not None:
        x = collectives.copy_to(x, group)
    h = x @ w_up
    if b_up is not None:
        h = h + b_up
    h = F.gelu(h, approximate="tanh") @ w_down
    if group is not None:
        h = collectives.reduce_from(h, group)
    if b_down is not None:
        h = h + b_down
    return h


# -----------------------------------------------------------------------------
# Rotary position embeddings
# -----------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, head_dim: int,
                 theta: float) -> torch.Tensor:
    """float32 angles ``positions[..., None] * freqs`` -> ``[..., D/2]``."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    return positions[..., None].float() * freqs


def rope(positions: torch.Tensor, head_dim: int, *, theta: float = 10000.0
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (float32) for positions ``[...]`` -> ``[..., D/2]``."""
    angles = _rope_angles(positions, head_dim, theta)
    return torch.cos(angles), torch.sin(angles)


def mrope_frequencies(positions: torch.Tensor, head_dim: int,
                      sections: tuple[int, int, int], *,
                      theta: float = 10000.0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE (Qwen2-VL): the ``head_dim / 2`` frequency slots are
    split into (temporal, height, width) sections, each rotated by its own
    position stream.  positions ``[3, ...]`` (text tokens carry one id in
    all three streams, image patches their grid coordinates) -> float32
    cos/sin ``[..., D/2]``; ``sections`` must sum to ``D/2``."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    angles = _rope_angles(positions, head_dim, theta)   # [3, ..., half]
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(angles[i, ..., start:start + sec])
        start += sec
    merged = torch.cat(parts, dim=-1)
    return torch.cos(merged), torch.sin(merged)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate head vectors.  x: ``[..., S, H, D]``; cos/sin ``[..., S,
    D/2]``.  Split-halves convention (LLaMA): ``(x1, x2) -> (x1 c - x2 s,
    x2 c + x1 s)``, computed in the promoted type and cast back to
    ``x``'s dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# -----------------------------------------------------------------------------
# Utilities
# -----------------------------------------------------------------------------


def unbind_layers(params: dict) -> list[dict]:
    """Every layer's parameters: views from one ``unbind(0)`` of each
    stacked ``[L, ...]`` tensor of ``params["layers"]``, through nested
    dicts of any depth (the norms', the MoE's ``moe/shared``).  Under
    autograd the backward of an ``unbind`` stacks the layers' gradients
    into one ``[L, ...]`` tensor per leaf, where indexing each layer would
    scatter every layer's gradient into a zero tensor of the whole stack
    and sum them."""
    def split(node):
        if isinstance(node, dict):
            parts = {k: split(v) for k, v in node.items()}
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        return node.unbind(0)

    n = tree_leaves(params["layers"])[0].shape[0]
    return split(params["layers"])


def mask_padded_vocab(logits: torch.Tensor, real_vocab: int, *,
                      offset: int = 0) -> torch.Tensor:
    """Set logits of padded vocab columns (``>= real_vocab``) to the finite
    ``NEG_INF``, so they never win softmax or argmax.  ``offset``: the
    vocabulary index of the first column (a rank's block of
    vocabulary-parallel logits)."""
    v = logits.shape[-1]
    if offset + v <= real_vocab:
        return logits
    col = torch.arange(offset, offset + v, device=logits.device)
    neg = torch.tensor(NEG_INF, dtype=logits.dtype, device=logits.device)
    return torch.where(col < real_vocab, logits, neg)


# -----------------------------------------------------------------------------
# Rematerialisation
# -----------------------------------------------------------------------------


def remat_checkpoints(remat: str) -> bool:
    """Whether ``remat`` recomputes a block in the backward pass: ``"full"``
    and ``"dots"`` do, ``"none"`` does not."""
    return remat in ("full", "dots")


def dots_policy(ctx, func, *args, **kwargs):
    """The selective checkpoint's policy for ``remat="dots"``: save
    (``MUST_SAVE``) the output of a product without batch dimensions,
    recompute (``PREFER_RECOMPUTE``) everything else, as JAX's
    ``checkpoint_dots_with_no_batch_dims``.

    A product without batch dimensions reaches dispatch as ``aten.mm`` or
    ``aten.addmm`` (``x @ W`` with a 3-D ``x`` folds its leading axes).
    An ``aten.bmm`` is batched and recomputed -- the attention's grouped
    einsums, the MoE experts -- unless its batch is 1: ``torch.einsum``
    writes an unbatched contraction (``"bsd,de->bse"``) as a ``bmm`` of
    batch 1, so such a ``bmm`` is saved too.  The rule's cost: a product
    batched in JAX whose batch is 1 here (attention at one batch row and
    one KV head, one expert) is saved where JAX recomputes it; it never
    recomputes what JAX saves."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if func in (aten.mm.default, aten.addmm.default) or (
            func is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(dots_policy)


def remat_block(remat: str, fn, *args, save_products: bool = False):
    """``fn(*args)`` as ``remat`` runs a block.  With grad enabled,
    ``"full"`` runs it under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are recomputed in the backward pass.  ``"dots"`` does
    the same, and with ``save_products`` (the transformer's blocks) it
    keeps the outputs ``dots_policy`` saves, so the recomputation skips
    those products.  Without grad, or under ``"none"``, ``fn(*args)``.

    Against JAX's residuals the policy holds one activation more per block:
    torch's selective checkpoint keeps every product it saves until the
    block's recomputation, the block's last product too (the FFN's down
    projection, whose output only the residual sum reads), where JAX keeps
    only what its backward reads.  At float32 that is ``4 * B * S *
    d_model`` bytes a layer."""
    if not (remat_checkpoints(remat) and torch.is_grad_enabled()):
        return fn(*args)
    if remat == "dots" and save_products:
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_dots_context)
    return checkpoint(fn, *args, use_reentrant=False)
