"""Step functions, as the JAX package's ``launch/steps.py`` builds them.

  train_step(params, opt_state, batch)   -> (params, opt_state, metrics)
  prefill_step(params, batch, cache)     -> (logits, cache)
  serve_step(params, tokens, cache)      -> (logits, cache)

``build_train_step(cfg, opt, grad_compress)`` returns the first:

loss -> gradients (summed in float32 over microbatches) -> the optional
gradient hook (the approximate collective's quantize round trip,
``core.approx_comm.make_grad_compressor``) -> AdamW.  The microbatch
count follows the JAX adaptive rule with a data-parallel size of 1 (the
port has no mesh): ``cfg.train_microbatches``, lowered until it divides the
batch.  The first half is also exposed (``compute_grads``), so a caller
can run the hook and ``optim.adamw.adamw_update`` on gradients it already
has, as the step does.  AdamW writes the new parameters and moments into
the tensors it is given, where the JAX step donates them.

``build_prefill_step`` / ``build_serve_step(cfg, cell)`` return a
``StepBundle``: the step function of one shape cell, meta stand-ins of its
arguments (``arg_specs``, the counterpart of the JAX bundle's
``arg_structs``) and the argument the step writes in place
(``donate_argnums``: the cache, where the JAX step donates it).  A serve
cell's cache stands at ``length = seq_len``: one decode step at that
context.  The bundles hold no shardings; those come with ROADMAP Queue 1,
fleet mesh and sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ATTENTION_IMPLS, ModelConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.meta import loop_repeats, repeated
from repro_torch.models.registry import (Model, build_model, cache_spec,
                                         input_specs, param_specs)
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["build_train_step", "build_prefill_step", "build_serve_step",
           "StepBundle", "microbatch_count", "compute_grads"]

STEP_DEVICES = ("cuda", "cpu", "meta")


@dataclasses.dataclass
class StepBundle:
    """One (arch, cell) step: ``fn``, meta stand-ins of its arguments
    (``arg_specs``: shapes and dtypes, no storage), the arguments it writes
    in place (``donate_argnums``) and the device its real arguments live
    on (``device``)."""
    fn: Callable
    arg_specs: tuple
    donate_argnums: tuple
    device: torch.device


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
    # on the meta device the first microbatch stands for all of them
    reps = loop_repeats(microbatches, batch["tokens"], alike=True)
    for i, n in enumerate(reps):
        if not n:
            continue
        mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        with repeated(n):
            loss, grads = _value_and_grad(model, params, mb)
            tree_map(lambda a, g: a.add_(g), acc, grads)
            loss_sum = loss_sum + loss
        del loss, grads         # no iteration keeps its predecessor's
    tree_map(lambda a: a.div_(microbatches), acc)
    return loss_sum / microbatches, acc


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
        if grad_compress is not None:
            # rebinding drops the uncompressed gradients before AdamW's
            # float32 temporaries (no second copy of every gradient at the
            # update's peak)
            grads = grad_compress(grads)
        params, opt_state = adamw_update(opt, params, grads, opt_state)
        return params, opt_state, {"loss": loss.float()}

    return train_step


def _step_setup(cfg: ModelConfig, impl: "str | None", device
                ) -> tuple[ModelConfig, Model, torch.device]:
    """``cfg`` with ``attention_impl = impl`` (when given), its model, and
    the step's device: ``"cuda"`` by default (raising without a card),
    ``"cpu"`` or the dry-run's ``"meta"`` when asked, anything else
    raises."""
    dev = resolve_device(device)
    if dev.type not in STEP_DEVICES:
        raise ValueError(f"step device {dev}: one of {STEP_DEVICES}")
    if impl is not None:
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown impl {impl!r}; one of "
                             f"{ATTENTION_IMPLS}")
        cfg = dataclasses.replace(cfg, attention_impl=impl)
    return cfg, build_model(cfg), dev


def build_prefill_step(cfg: ModelConfig, cell: ShapeCell, *,
                       impl: "str | None" = None,
                       device: "torch.device | str | None" = None
                       ) -> StepBundle:
    """``prefill_step(params, batch, cache) -> (last logits [B, 1, V],
    cache)`` of ``cell`` (B prompts of ``seq_len`` positions into a cache of
    ``seq_len + DECODE_SLACK`` rows, written in place).  ``impl`` (default
    the config's ``attention_impl``) picks the routes as the model reads
    it: ``"kernel"`` the flash, decode and wkv kernels on the card,
    ``"chunked"`` / ``"naive"`` their plain counterparts (chunked or naive
    prefill attention, the einsum decode, ``wkv_plain``)."""
    cfg, model, dev = _step_setup(cfg, impl, device)

    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)

    specs = (param_specs(cfg), input_specs(cfg, cell)["batch"],
             cache_spec(cfg, cell.global_batch, cell.seq_len))
    return StepBundle(fn=prefill_step, arg_specs=specs, donate_argnums=(2,),
                      device=dev)


def build_serve_step(cfg: ModelConfig, cell: ShapeCell, *,
                     impl: "str | None" = None,
                     device: "torch.device | str | None" = None
                     ) -> StepBundle:
    """``serve_step(params, tokens [B, 1], cache) -> (logits [B, 1, V],
    cache)``: one decode step of ``cell`` against a cache of ``seq_len +
    DECODE_SLACK`` rows holding ``seq_len`` tokens (its spec's ``length``),
    the new row written in place.  ``impl`` and ``device`` as in
    ``build_prefill_step``."""
    cfg, model, dev = _step_setup(cfg, impl, device)

    def serve_step(params, tokens, cache):
        return model.decode_step(params, tokens, cache)

    specs = input_specs(cfg, cell)
    cache = dataclasses.replace(specs["cache"], length=cell.seq_len)
    return StepBundle(fn=serve_step,
                      arg_specs=(param_specs(cfg), specs["tokens"], cache),
                      donate_argnums=(2,), device=dev)
