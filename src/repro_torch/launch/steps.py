"""The training step, as the JAX package's ``launch/steps.py`` builds it.

``build_train_step(cfg, opt, grad_compress)`` returns

  train_step(params, opt_state, batch) -> (params, opt_state, metrics)

loss -> gradients (summed in float32 over microbatches) -> the optional
gradient hook (the approximate collective's quantize round trip,
``core.approx_comm.make_grad_compressor``) -> AdamW.  The microbatch
count follows the JAX adaptive rule with a data-parallel size of 1 (the
port has no mesh): ``cfg.train_microbatches``, lowered until it divides the
batch.  The two halves are also exposed (``compute_grads``,
``apply_grads``), so a caller can run the update on gradients it already
has.  AdamW writes the new parameters and moments into the tensors it is
given, where the JAX step donates them.

The prefill and serve step functions and the shardings wait for ROADMAP
Queue 1, the dry-run.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import Model, build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["build_train_step", "microbatch_count", "compute_grads",
           "apply_grads"]


def microbatch_count(cfg: ModelConfig, global_batch: int,
                     dp_size: int = 1) -> int:
    """The JAX step's microbatch rule: ``cfg.train_microbatches`` (at
    least 1), lowered until every microbatch has a whole share of the batch
    for each of ``dp_size`` data-parallel members."""
    m = max(1, cfg.train_microbatches)
    while m > 1 and (global_batch % m != 0
                     or (global_batch // m) % dp_size != 0):
        m -= 1
    return m


def _value_and_grad(model: Model, params: dict, batch: dict
                    ) -> tuple[torch.Tensor, dict]:
    """The loss and its gradient with respect to every parameter leaf (the
    parameters themselves are left without ``requires_grad``)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = model.loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    # tree_leaves and tree_map both walk the keys in sorted order
    return loss.detach(), _fill(leaves, it)


def _fill(tree, it):
    if not isinstance(tree, dict):
        return next(it)
    return {k: _fill(tree[k], it) for k in sorted(tree)}


def compute_grads(model: Model, params: dict, batch: dict,
                  microbatches: int) -> tuple[torch.Tensor, dict]:
    """(loss, gradients) of one step.  One microbatch: the loss and the
    gradients in the parameters' dtype.  More: the batch is split into
    ``microbatches`` equal consecutive row blocks (the JAX reshape), the
    losses and float32 gradients summed over them in order, both divided
    by the count."""
    if microbatches == 1:
        return _value_and_grad(model, params, batch)
    b = batch["tokens"].shape[0] // microbatches
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    for i in range(microbatches):
        mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        loss, grads = _value_and_grad(model, params, mb)
        tree_map(lambda a, g: a.add_(g), acc, grads)
        loss_sum = loss_sum + loss
        del grads
    tree_map(lambda a: a.div_(microbatches), acc)
    return loss_sum / microbatches, acc


def apply_grads(opt: AdamWConfig, params: dict, opt_state: dict,
                grads: dict, grad_compress: Callable | None = None
                ) -> tuple[dict, dict, dict]:
    """The gradient hook (when given), then AdamW; returns (params,
    opt_state, the gradients AdamW took)."""
    if grad_compress is not None:
        grads = grad_compress(grads)
    params, opt_state = adamw_update(opt, params, grads, opt_state)
    return params, opt_state, grads


def build_train_step(cfg: ModelConfig, opt: AdamWConfig | None = None,
                     grad_compress: Callable | None = None) -> Callable:
    """The full training step of ``cfg``'s model: loss -> gradients ->
    ``grad_compress`` (the approximate collective's hook, optional) ->
    AdamW (``opt``, default ``AdamWConfig()``).  The step returns
    ``(params, opt_state, {"loss": float32 0-d tensor})``."""
    model = build_model(cfg)
    opt = opt or AdamWConfig()

    def train_step(params: dict, opt_state: dict, batch: dict
                   ) -> tuple[dict, dict, dict[str, Any]]:
        m = microbatch_count(cfg, batch["tokens"].shape[0])
        loss, grads = compute_grads(model, params, batch, m)
        params, opt_state, _ = apply_grads(opt, params, opt_state, grads,
                                           grad_compress)
        return params, opt_state, {"loss": loss.float()}

    return train_step
