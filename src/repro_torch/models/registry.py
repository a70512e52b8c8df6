"""Architecture registry: family -> model module, and random batches.

The port of the JAX package's ``models/registry.py`` for the families the
port has (dense, moe and vlm: ``transformer``; ssm: ``rwkv6``; hybrid:
``zamba2``).  ``Model`` is the uniform facade over the family module
(``init_params``, ``forward``, ``loss_fn``, ``init_cache``, ``prefill``,
``decode_step``); ``make_batch`` draws random batches from a
``torch.Generator``: tokens, with labels for training, and for the VLM
family the stub frontend's patch embeddings before the text.  ``input_specs`` /
``cache_spec`` wait for the dry-run's port (ROADMAP Queue 1, the dry-run).
"""

from __future__ import annotations

import dataclasses
from types import ModuleType

import torch

from repro_torch.configs import PENDING_FAMILIES
from repro_torch.configs.base import ModelConfig, dtype_of
from repro_torch.device import resolve_device
from repro_torch.models import rwkv6, transformer, zamba2

__all__ = ["Model", "build_model", "make_batch", "DECODE_SLACK"]

# Extra KV-cache slots past the served length (the JAX package's value:
# 256 keeps S_max divisible by its mesh axes; the port keeps it so both
# packages' caches have one shape).
DECODE_SLACK = 256

_FAMILY_MODULES: dict[str, ModuleType] = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": rwkv6,
    "hybrid": zamba2,
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    module: ModuleType

    def init_params(self, generator: torch.Generator, *,
                    device: "torch.device | str | None" = None):
        return self.module.init_params(generator, self.cfg, device=device)

    def forward(self, params, batch):
        return self.module.forward(params, batch, self.cfg)

    def loss_fn(self, params, batch):
        """The family's training loss; a family without one (rwkv6) raises
        ``NotImplementedError`` (ROADMAP Queue 1, rwkv6 training)."""
        fn = getattr(self.module, "loss_fn", None)
        if fn is None:
            raise NotImplementedError(
                f"training the {self.cfg.family!r} family is not ported yet "
                f"(ROADMAP Queue 1, rwkv6 training)")
        return fn(params, batch, self.cfg)

    def init_cache(self, batch: int, max_len: int, **kw):
        return self.module.init_cache(self.cfg, batch, max_len, **kw)

    def prefill(self, params, batch, cache):
        return self.module.prefill(params, batch, self.cfg, cache)

    def decode_step(self, params, tokens, cache):
        return self.module.decode_step(params, tokens, self.cfg, cache)


def build_model(cfg: ModelConfig) -> Model:
    """The model facade of ``cfg``'s family; families the port lacks, and
    what the family's module lacks (its ``check_supported``), raise
    ``NotImplementedError`` naming the ROADMAP Queue 1 item that ports
    them."""
    if cfg.family not in _FAMILY_MODULES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1, "
            f"{PENDING_FAMILIES[cfg.family]})" if cfg.family in
            PENDING_FAMILIES else f"unknown family {cfg.family!r}")
    module = _FAMILY_MODULES[cfg.family]
    module.check_supported(cfg)
    return Model(cfg=cfg, module=module)


def make_batch(cfg: ModelConfig, b: int, s: int, *,
               generator: torch.Generator,
               device: "torch.device | str | None" = None,
               train: bool = False) -> dict:
    """A random batch of ``s`` positions, as the JAX package's
    ``make_batch``: ``tokens`` i32 ``[b, s]`` in ``[0, vocab_size)`` and,
    with ``train``, ``labels`` drawn the same way.  For the VLM family the
    first ``frontend_tokens`` positions are stub patch embeddings,
    ``patch_embeds`` ``0.02 * normal`` ``[b, frontend_tokens, d_model]``
    in the compute dtype, and the tokens (and labels) cover the text tail,
    ``[b, max(1, s - frontend_tokens)]``.  Drawn from ``generator`` on
    ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    s_text = max(1, s - cfg.frontend_tokens) if cfg.family == "vlm" else s

    def tokens():
        return torch.randint(0, cfg.vocab_size, (b, s_text),
                             generator=generator, device=dev,
                             dtype=torch.int32)

    out = {"tokens": tokens()}
    if cfg.family == "vlm":
        out["patch_embeds"] = (torch.randn(
            (b, cfg.frontend_tokens, cfg.d_model), generator=generator,
            device=dev) * 0.02).to(dtype_of(cfg.compute_dtype))
    if train:
        out["labels"] = tokens()
    return out
