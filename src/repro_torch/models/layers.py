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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves

__all__ = ["rms_norm", "layer_norm", "init_norm", "init_linear", "swiglu",
           "gelu_mlp", "rope", "apply_rope", "mrope_frequencies",
           "mask_padded_vocab",
           "unbind_layers", "NEG_INF", "DRAW_BLOCK"]

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
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: ``(silu(x W_g) * (x W_u)) W_d``."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
             b_up: torch.Tensor | None = None,
             b_down: torch.Tensor | None = None) -> torch.Tensor:
    """GELU FFN with the tanh approximation (``jax.nn.gelu``'s default)."""
    h = x @ w_up
    if b_up is not None:
        h = h + b_up
    h = F.gelu(h, approximate="tanh") @ w_down
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


def mask_padded_vocab(logits: torch.Tensor, real_vocab: int) -> torch.Tensor:
    """Set logits of padded vocab columns (``>= real_vocab``) to the finite
    ``NEG_INF``, so they never win softmax or argmax."""
    v = logits.shape[-1]
    if v == real_vocab:
        return logits
    col = torch.arange(v, device=logits.device)
    neg = torch.tensor(NEG_INF, dtype=logits.dtype, device=logits.device)
    return torch.where(col < real_vocab, logits, neg)
