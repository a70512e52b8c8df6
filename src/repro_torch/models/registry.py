"""Architecture registry: family -> model module, and random batches.

The port of the JAX package's ``models/registry.py`` for every family
(dense, moe and vlm: ``transformer``; ssm: ``rwkv6``; hybrid: ``zamba2``;
audio: ``encdec``).  ``Model`` is the uniform facade over the family
module (``init_params``, ``forward``, ``loss_fn``, ``init_cache``,
``prefill``, ``decode_step``); ``make_batch`` draws random batches from a
``torch.Generator``: tokens, with labels for training, for the VLM family
the stub frontend's patch embeddings before the text, and for the audio
family the encoder's stub frame embeddings.

``param_specs``, ``input_specs`` and ``cache_spec`` are the counterparts of
the JAX package's ``jax.eval_shape`` / ``jax.ShapeDtypeStruct`` stand-ins:
tensors on ``torch.device("meta")`` of the same shapes and dtypes, which
allocate nothing.  The dry-run (``launch/dryrun.py``) runs a cell's step
on them.
"""

from __future__ import annotations

import dataclasses
from types import ModuleType

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell, dtype_of
from repro_torch.device import resolve_device
from repro_torch.meta import META, MetaPass
from repro_torch.models import encdec, rwkv6, transformer, zamba2

__all__ = ["Model", "build_model", "make_batch", "param_specs",
           "input_specs", "cache_spec", "DECODE_SLACK"]

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


# -----------------------------------------------------------------------------
# meta stand-ins per shape cell
# -----------------------------------------------------------------------------


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` on the meta device: ``init_params``'s
    leaves, shapes and dtypes, with no storage (a meta tensor's draw
    computes nothing; ``MetaPass`` runs the init's repeated draws once)."""
    with MetaPass():
        return build_model(cfg).init_params(torch.Generator(), device=META)


def _batch_structs(cfg: ModelConfig, b: int, s: int, *, train: bool) -> dict:
    """Token / embedding / label stand-ins for one step over ``[b, s]``
    positions (the JAX ``_batch_structs``; ``make_batch``'s split)."""
    compute = dtype_of(cfg.compute_dtype)

    def empty(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=META)

    specs: dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        s_text = max(1, s - cfg.frontend_tokens)
        specs["tokens"] = empty((b, s_text))
        specs["patch_embeds"] = empty((b, cfg.frontend_tokens, cfg.d_model),
                                      compute)
    elif cfg.family == "audio":
        s_enc = s // 2 if train else s
        s_text = s - s_enc if train else max(1, s // 8)
        specs["embeds"] = empty((b, s_enc, cfg.d_model), compute)
        specs["tokens"] = empty((b, s_text))
    else:
        s_text = s
        specs["tokens"] = empty((b, s))
    if train:
        specs["labels"] = empty((b, s_text))
    return specs


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Meta stand-ins for the inputs of this (arch, cell)'s step:
    ``{"batch": ...}`` for a train or prefill cell, ``{"tokens": [B, 1],
    "cache": cache_spec(...)}`` for a decode cell."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        return {"batch": _batch_structs(cfg, b, s,
                                        train=cell.kind == "train")}
    if cell.kind == "decode":
        return {"tokens": torch.empty((b, 1), dtype=torch.int32,
                                      device=META),
                "cache": cache_spec(cfg, b, s)}
    raise ValueError(cell.kind)


def cache_spec(cfg: ModelConfig, b: int, s: int):
    """``init_cache(b, s + DECODE_SLACK)`` on the meta device (the audio
    family's encoder rows ``enc_len = s``), at length 0."""
    kw = {"enc_len": s} if cfg.family == "audio" else {}
    return build_model(cfg).init_cache(b, s + DECODE_SLACK, device=META,
                                       **kw)


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
    specs = _batch_structs(cfg, b, s, train=train)
    out = {}
    for name in ("tokens", "patch_embeds", "embeds", "labels"):
        if name not in specs:
            continue
        spec = specs[name]
        if spec.is_floating_point():
            out[name] = (torch.randn(spec.shape, generator=generator,
                                     device=dev) * 0.02).to(spec.dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=generator, device=dev,
                                      dtype=spec.dtype)
    return out
