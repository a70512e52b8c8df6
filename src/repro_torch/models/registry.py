"""Architecture registry: family -> model module, and random batches.

The port of the JAX package's ``models/registry.py`` for the families the
port has (dense, ssm).  ``Model`` is the uniform facade over the family
module (``init_params``, ``forward``, ``loss_fn``, ``init_cache``,
``prefill``, ``decode_step``); ``make_batch`` draws random token batches,
with labels for training, from a ``torch.Generator``.  ``input_specs`` /
``cache_spec`` wait for the dry-run's port.
"""

from __future__ import annotations

import dataclasses
from types import ModuleType

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import rwkv6, transformer

__all__ = ["Model", "build_model", "make_batch", "DECODE_SLACK"]

# Extra KV-cache slots past the served length (the JAX package's value:
# 256 keeps S_max divisible by its mesh axes; the port keeps it so both
# packages' caches have one shape).
DECODE_SLACK = 256

_FAMILY_MODULES: dict[str, ModuleType] = {
    "dense": transformer,
    "ssm": rwkv6,
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
        """The family's training loss; a family without one raises
        ``NotImplementedError`` (ROADMAP Queue 1 item 11)."""
        fn = getattr(self.module, "loss_fn", None)
        if fn is None:
            raise NotImplementedError(
                f"training the {self.cfg.family!r} family is not ported yet "
                f"(ROADMAP Queue 1 item 11)")
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
    ``NotImplementedError`` (ROADMAP Queue 1 item 11)."""
    if cfg.family not in _FAMILY_MODULES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item "
            f"11)")
    module = _FAMILY_MODULES[cfg.family]
    module.check_supported(cfg)
    return Model(cfg=cfg, module=module)


def make_batch(cfg: ModelConfig, b: int, s: int, *,
               generator: torch.Generator,
               device: "torch.device | str | None" = None,
               train: bool = False) -> dict:
    """A random batch: ``tokens`` i32 ``[b, s]`` in ``[0, vocab_size)``
    and, with ``train``, ``labels`` drawn the same way (as the JAX
    package's ``make_batch``), from ``generator`` on ``device`` (default
    ``"cuda"``)."""
    dev = resolve_device(device)
    out = {}
    for name in ("tokens", "labels") if train else ("tokens",):
        out[name] = torch.randint(0, cfg.vocab_size, (b, s),
                                  generator=generator, device=dev,
                                  dtype=torch.int32)
    return out
