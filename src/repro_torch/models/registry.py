"""Architecture registry: family -> model module, and random batches.

The port of the JAX package's ``models/registry.py`` for every family
(dense, moe and vlm: ``transformer``; ssm: ``rwkv6``; hybrid: ``zamba2``;
audio: ``encdec``).  ``Model`` is the uniform facade over the family
module (``init_params``, ``forward``, ``loss_fn``, ``init_cache``,
``prefill``, ``decode_step``); ``make_batch`` draws random batches from a
``torch.Generator``: tokens, with labels for training, for the VLM family
the stub frontend's patch embeddings before the text, and for the audio
family the encoder's stub frame embeddings.  ``input_specs`` /
``cache_spec`` wait for the dry-run's port (ROADMAP Queue 1, the
dry-run).
"""

from __future__ import annotations

import dataclasses
from types import ModuleType

import torch

from repro_torch.configs.base import ModelConfig, dtype_of
from repro_torch.device import resolve_device
from repro_torch.models import encdec, rwkv6, transformer, zamba2

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
    "audio": encdec,
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
        return self.module.loss_fn(params, batch, self.cfg)

    def init_cache(self, batch: int, max_len: int, **kw):
        return self.module.init_cache(self.cfg, batch, max_len, **kw)

    def prefill(self, params, batch, cache):
        return self.module.prefill(params, batch, self.cfg, cache)

    def decode_step(self, params, tokens, cache):
        return self.module.decode_step(params, tokens, self.cfg, cache)


def build_model(cfg: ModelConfig) -> Model:
    """The model facade of ``cfg``'s family.  An unknown family raises
    ``NotImplementedError``, and so does what the family's module lacks
    (its ``check_supported``), naming the ROADMAP Queue 1 item that ports
    it."""
    if cfg.family not in _FAMILY_MODULES:
        raise NotImplementedError(f"unknown family {cfg.family!r}")
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
    ``patch_embeds`` ``[b, frontend_tokens, d_model]``, and the tokens (and
    labels) cover the text tail, ``[b, max(1, s - frontend_tokens)]``.  For
    the audio family ``embeds`` are the encoder's stub frames and the
    tokens (and labels) the decoder's: a training batch splits ``s`` into
    ``s // 2`` frames and ``s - s // 2`` tokens, a serving batch has ``s``
    frames and ``max(1, s // 8)`` tokens.  Embeddings are ``0.02 *
    normal`` in the compute dtype.  Drawn from ``generator`` on ``device``
    (default ``"cuda"``)."""
    dev = resolve_device(device)
    n_embed, s_text = 0, s
    if cfg.family == "vlm":
        n_embed, s_text = cfg.frontend_tokens, max(1, s - cfg.frontend_tokens)
    elif cfg.family == "audio":
        n_embed = s // 2 if train else s
        s_text = s - n_embed if train else max(1, s // 8)

    def tokens():
        return torch.randint(0, cfg.vocab_size, (b, s_text),
                             generator=generator, device=dev,
                             dtype=torch.int32)

    out = {"tokens": tokens()}
    if cfg.family in ("vlm", "audio"):
        key = "patch_embeds" if cfg.family == "vlm" else "embeds"
        out[key] = (torch.randn((b, n_embed, cfg.d_model),
                                generator=generator, device=dev) * 0.02
                    ).to(dtype_of(cfg.compute_dtype))
    if train:
        out["labels"] = tokens()
    return out
