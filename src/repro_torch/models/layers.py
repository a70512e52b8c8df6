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

The tensor-parallel pieces every family's partitioned step shares: the
norms over a last axis split across the model axis (``group=``: their
moments summed by ``group_sum``), a leaf's whole (``gather_model``,
``model_whole``) or the rank's part (``model_slice``), and the
vocabulary-parallel embedding, head and loss (``embed_tokens``,
``vocab_logits``, ``next_token_loss``).  Under the ``sequence_parallel``
hint the FFNs take ``seq_dim`` (the rank's rows gathered on entry, the
sums reduce-scattered back), the embedding and head ``seq``, and
``seq_rows`` / ``seq_weight`` give a whole value's rows and a leaf used
on them their gradients' sums.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import dtype_of
from repro_torch.sharding import collectives, spmd
from repro_torch.sharding.api import compute_axes
from repro_torch.tree import tree_leaves

__all__ = ["rms_norm", "layer_norm", "group_sum", "init_norm",
           "init_linear", "swiglu", "gelu_mlp", "rope", "apply_rope",
           "mrope_frequencies", "mask_padded_vocab", "unbind_layers",
           "remat_checkpoints", "remat_block", "dots_policy", "model_split",
           "gather_model", "model_whole", "model_slice", "seq_rows",
           "seq_weight", "embed_tokens",
           "vocab_logits", "next_token_loss", "NEG_INF", "DRAW_BLOCK"]

NEG_INF = -2.3819763e38  # large finite negative, bf16-safe (the JAX value)
DRAW_BLOCK = 1 << 24     # float32 elements ``init_linear`` draws at a time


# -----------------------------------------------------------------------------
# Norms
# -----------------------------------------------------------------------------


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the model-axis ``group``, its gradient summed
    over the group too (each rank's part of the loss reads the sum): a
    norm's moments over a last axis split across the group."""
    return collectives.copy_to(collectives.reduce_from(x, group), group)


def _split_norm(group) -> bool:
    return group is not None and collectives.size(group) > 1


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-6, group=None) -> torch.Tensor:
    """RMS norm over the last axis in float32, cast back to ``x``'s dtype.
    With a model-axis ``group`` (of more than one rank) the last axis is
    the rank's block of one split over the group (``scale`` its block
    too): the sum of squares is summed over the group."""
    x32 = x.float()
    if _split_norm(group):
        n = x.shape[-1] * collectives.size(group)
        var = group_sum(x32.square().sum(-1, keepdim=True), group) / n
    else:
        var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5, group=None) -> torch.Tensor:
    """Layer norm over the last axis in float32 (biased variance, as
    ``jnp.var``), cast back to ``x``'s dtype.  ``group`` as in
    ``rms_norm``: the mean, then the centred sum of squares, summed over
    the group."""
    x32 = x.float()
    if _split_norm(group):
        n = x.shape[-1] * collectives.size(group)
        mu = group_sum(x32.sum(-1, keepdim=True), group) / n
        var = group_sum((x32 - mu).square().sum(-1, keepdim=True),
                        group) / n
    else:
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


def _ffn_entry(x: torch.Tensor, group, seq_dim) -> torch.Tensor:
    """A column-parallel block's input over the model-axis ``group``:
    Megatron's ``f`` (``copy_to``) for a replicated ``x``, or with
    ``seq_dim`` the rank's rows of a split sequence gathered
    (``gather_summed``, whose reduce-scatter in the backward pass sums the
    ranks' partial gradients: it takes ``copy_to``'s place, never stands
    beside it)."""
    if group is None:
        return x
    if seq_dim is None:
        return collectives.copy_to(x, group)
    return collectives.gather_summed(x, seq_dim, group)


def _ffn_exit(y: torch.Tensor, group, seq_dim) -> torch.Tensor:
    """A row-parallel block's partial sums over ``group``: all-reduced,
    or with ``seq_dim`` reduce-scattered to the rank's rows."""
    if group is None:
        return y
    if seq_dim is None:
        return collectives.reduce_from(y, group)
    return collectives.scatter_from(y, seq_dim, group)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, *, group=None, reduce: bool = True,
           seq_dim: "int | None" = None) -> torch.Tensor:
    """SwiGLU FFN: ``(silu(x W_g) * (x W_u)) W_d``.

    With a model-axis ``group`` the weights are the rank's blocks of a
    column-parallel ``W_g`` / ``W_u`` (``[d, f/m]``) and a row-parallel
    ``W_d`` (``[f/m, d]``): ``x`` enters as Megatron's ``f`` (its gradient
    summed over the group) and the partial products are summed by one
    all-reduce over the group (``reduce=False`` leaves the partial sum to a
    caller that adds it to another before reducing).  With ``seq_dim``
    (sequence parallelism) ``x`` is the rank's rows along that dim of a
    sequence split over the group: gathered on entry, and the sum
    reduce-scattered back to the rank's rows."""
    x = _ffn_entry(x, group, seq_dim)
    y = (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
    return _ffn_exit(y, group, seq_dim) if reduce else y


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
             b_up: torch.Tensor | None = None,
             b_down: torch.Tensor | None = None, *,
             group=None, seq_dim: "int | None" = None) -> torch.Tensor:
    """GELU FFN with the tanh approximation (``jax.nn.gelu``'s default);
    ``group`` and ``seq_dim`` as in ``swiglu`` (the up bias is the rank's
    block of it, the down bias is added once, after the reduction)."""
    x = _ffn_entry(x, group, seq_dim)
    h = x @ w_up
    if b_up is not None:
        h = h + b_up
    h = _ffn_exit(F.gelu(h, approximate="tanh") @ w_down, group, seq_dim)
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
# Tensor-parallel pieces: what every family's layers read of a rank's
# ``sharding.api.ComputeAxes`` in a partitioned step
# -----------------------------------------------------------------------------


def model_split(tp, path: tuple) -> bool:
    """Whether the parameter leaf at ``path`` is split over the model
    axis."""
    plan = tp.plan(path)
    return plan is not None and plan.model_dim is not None


def gather_model(p: dict, tp, names: tuple, prefix: tuple = ("layers",)
                 ) -> dict:
    """A layer's ``p`` (its leaves under ``prefix``) with the leaves
    ``names`` gathered whole over the model axis where the specs split
    them (used alike on every rank: the gradient of a block is its
    slice)."""
    p = dict(p)
    for n in names:
        plan = tp.plan(tuple(prefix) + (n,))
        if plan is not None and plan.model_dim is not None:
            p[n] = collectives.gather_from(p[n], plan.model_dim,
                                           tp.model_group)
    return p


def model_whole(w: torch.Tensor, tp, path: tuple) -> torch.Tensor:
    """The leaf ``w`` at ``path`` gathered whole over the model axis where
    the specs split it, for a computation every rank repeats whose
    outputs feed the rank's own part (rwkv6's LoRAs, zamba2's ``in_proj``
    re-laid to the rank's heads): each rank's gradient of it is a partial
    sum, reduce-scattered back to the blocks in the backward pass."""
    plan = tp.plan(tuple(path))
    if plan is None or plan.model_dim is None:
        return w
    return collectives.gather_summed(w, plan.model_dim, tp.model_group)


def model_slice(x: torch.Tensor, dim: int, tp) -> torch.Tensor:
    """The rank's block along ``dim`` of a leaf (or value) the model axis
    leaves whole, used in the rank's part of the work: its gradient summed
    over the group (each rank's reaches its block only)."""
    if tp.model_size == 1:
        return x
    x = collectives.copy_to(x, tp.model_group)
    n = x.shape[dim] // tp.model_size
    return x.narrow(dim, tp.model_rank * n, n)


# -- sequence parallelism (the ``sequence_parallel`` hint) ---------------------
#
# Between sub-blocks a rank holds its ``S/m`` rows of the residual stream
# (``ComputeAxes.seq_split``).  Where the model axis computes, a rank's
# gradient of its rows is the whole one: a value every rank holds whole
# and slices (``seq_rows``) sums its gradient over the group, and a leaf
# used on the rank's rows alone (``seq_weight``) has its partial gradient
# summed.  Under ``zero3`` (no model-axis compute, the sequence over the
# model axis all the same) every rank's gradient is a part, summed with
# the rest by the DP reduction over every axis, and neither sums.


def seq_rows(x: torch.Tensor, tp, dim: int = 1) -> torch.Tensor:
    """The rank's rows along ``dim`` of a value every rank holds whole:
    ``model_slice`` where the model axis computes, the slice alone under
    ``zero3``."""
    if tp.model_group is not None:
        return model_slice(x, dim, tp)
    first, n = tp.own_rows(x.shape[dim])
    return x.narrow(dim, first, n)


def seq_weight(w: torch.Tensor, tp, path: "tuple | None" = None
               ) -> torch.Tensor:
    """A leaf (at ``path``, or unsplit) as the rank's rows of a split
    sequence use it, whole: its gradient, a part from those rows, summed
    over the model axis -- gathered by ``gather_summed`` where the specs
    split it, else through ``copy_to``.  Under ``zero3``, as it is."""
    if tp.model_group is None:
        return w
    if path is not None and model_split(tp, path):
        return model_whole(w, tp, path)
    return collectives.copy_to(w, tp.model_group)


def embed_tokens(params: dict, tokens: torch.Tensor, cfg, *,
                 name: str = "embed", seq: bool = False) -> torch.Tensor:
    """The token embeddings ``params[name][tokens]`` in the compute dtype.
    In a partitioned step the table's FSDP block is gathered and, where
    the model axis splits the vocabulary, each rank looks up the tokens in
    its rows (zero for the others') and an all-reduce sums the ranks'
    lookups.  With ``seq`` (the sequence split, ``ComputeAxes.seq_split``)
    the rank's rows of the embeddings: the ranks' lookups
    reduce-scattered along the sequence where the vocabulary is split,
    else the rank's rows of the whole lookup (``seq_rows``)."""
    compute = dtype_of(cfg.compute_dtype)
    tp = compute_axes()
    if tp is None:
        return params[name][tokens.long()].to(compute)
    table = spmd.fsdp_gather({name: params[name]}, tp)[name]
    if not model_split(tp, (name,)) or tp.model_size == 1:
        if seq and tp.model_group is None:       # zero3: the rows alone
            tokens = seq_rows(tokens, tp)
        rows = table[tokens.long()].to(compute)
        return seq_rows(rows, tp) if seq and tp.model_group is not None \
            else rows
    n = table.shape[0]
    local = tokens.long() - tp.model_rank * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].to(compute)
    rows = rows * mine[..., None].to(compute)
    if seq:
        return collectives.scatter_from(rows, 1, tp.model_group)
    return collectives.reduce_from(rows, tp.model_group)


def _head(params: dict, name: str, tied: bool, tp
          ) -> "tuple[torch.Tensor, int]":
    """The output head ``[D, V]`` as this rank computes with it, and the
    vocabulary index of its first column: the rank's columns where the
    model axis splits the vocabulary, else all of them."""
    w = params[name]
    if tp is not None:
        w = spmd.fsdp_gather({name: w}, tp)[name]
    head = w.T if tied else w
    split = tp is not None and model_split(tp, (name,))
    return head, tp.model_rank * head.shape[1] if split else 0


def vocab_logits(params: dict, h: torch.Tensor, cfg, *,
                 name: str = "lm_head", tied: bool = False,
                 seq: bool = False) -> torch.Tensor:
    """The logits ``h @ params[name]`` (``params[name].T`` where ``tied``:
    the embedding) ``[B, S, V]``, padded columns masked -- in a
    partitioned step the rank's block of the vocabulary where the model
    axis splits it, ``[B, S, V/m]`` (``partition.logits_spec``).  With
    ``seq``, ``h`` holds the rank's rows of a split sequence, gathered
    first (the logits keep the sequence whole, as JAX's): by
    ``gather_summed`` where each rank's gradient of them is a part (its
    vocabulary columns'; under ``zero3`` every rank's whole loss, summed
    with the others' as the DP reduction sums), by ``gather_from`` where
    a whole head gives every rank the whole gradient."""
    tp = compute_axes()
    head, first = _head(params, name, tied, tp)
    split = head.shape[1] < cfg.padded_vocab         # the rank's columns
    if seq:
        alike = tp.model_group is not None and not split
        gather = collectives.gather_from if alike else \
            collectives.gather_summed
        h = gather(h, 1, tp.seq_group)
    elif split:
        h = collectives.copy_to(h, tp.model_group)
    return mask_padded_vocab(h @ head.to(h.dtype), cfg.vocab_size,
                             offset=first)


class _VocabParallelNLL(torch.autograd.Function):
    """The negative log-likelihood of ``labels`` under logits whose
    vocabulary is split over the model axis: each rank holds ``[N, V/m]``
    float32 columns from ``first``.  The max, the sum of exponents and the
    label's logit are each reduced over the group; the backward pass is
    the rank's columns of ``softmax - onehot``."""

    @staticmethod
    def forward(ctx, logits, labels, first, group):
        C = collectives
        n = logits.shape[1]
        top = C.all_reduce(logits.amax(-1), group, "max")
        z = logits - top[:, None]
        e = torch.exp(z)
        total = C.all_reduce(e.sum(-1), group)
        local = labels - first
        mine = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)
        picked = C.all_reduce(z.gather(-1, idx[:, None])[:, 0]
                              * mine.to(z.dtype), group)
        ctx.save_for_backward(e.div_(total[:, None]), idx, mine)
        return torch.log(total) - picked

    @staticmethod
    def backward(ctx, g):
        p, idx, mine = ctx.saved_tensors
        grad = p.scatter_add(-1, idx[:, None], -mine.to(p.dtype)[:, None])
        return grad * g[:, None], None, None, None


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor, cfg
                    ) -> torch.Tensor:
    """The JAX ``loss_fn``'s cross-entropy: float32 ``logits`` ``[B, S,
    V]`` (a caller casts them, so the compute-dtype logits are freed
    first), log-softmax, the negative log-likelihood of ``labels`` ``[B,
    S]`` averaged over the positions with ``labels >= 0``.  Logits of the
    rank's vocabulary block (a partitioned step) take the
    vocabulary-parallel cross-entropy."""
    labels = labels.long()
    tp = compute_axes()
    if tp is not None and logits.shape[-1] < cfg.padded_vocab:
        first = tp.model_rank * logits.shape[-1]
        nll = _VocabParallelNLL.apply(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1), first,
            tp.model_group).reshape(labels.shape)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


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
