"""Batched serving driver: prefill a batch of prompts, then decode tokens
against the model's cache (a preallocated KV cache for the dense, MoE and
VLM families, the recurrent state for the SSM family, both -- each Mamba2
layer's state and each shared-block invocation's keys and values -- for
the hybrid family).

The port of the JAX package's ``launch/serve.py``: the same loop (prefill
once, then ``gen`` decode steps for the whole batch, greedy or sampled),
the same cache size (``prompt_len + gen + DECODE_SLACK``) and the same
returned dict.  On a CUDA device the model runs with
``attention_impl="kernel"``: for the dense, MoE and VLM families prefill
goes through the hand-written flash attention kernel and every decode step
through the decode kernel, and so does each invocation of the hybrid
family's shared block (``zamba2-7b``, head_dim 112); for the SSM family
(``rwkv6-1.6b``) every layer's time-mix, at prefill and at each decode
step, goes through the wkv scan kernel.  A VLM prompt of ``prompt_len``
positions is ``frontend_tokens`` stub patch embeddings and the text after
them (``registry.make_batch``).  Times
end in ``torch.cuda.synchronize()`` on the card, so they cover the device
work and not only its enqueueing; as in the JAX package, a decode step's
time is the step alone, and the token pick after it is outside the span.

Usage (on the card; add ``--device cpu`` to run the reduced config on the
CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --batch 4 --prompt-len 64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch moonshot-v1-16b-a3b --full --batch 8 --prompt-len 1024

``--full`` serves the published widths; of the port's archs all but
``phi3.5-moe-42b-a6.6b`` (83.7 GB of bfloat16 weights) and
``qwen2-vl-72b`` (145.4 GB) fit one 80 GB card.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.registry import (DECODE_SLACK, Model, build_model,
                                         make_batch)
from repro_torch.models.rwkv6 import RWKVState
from repro_torch.models.transformer import KVCache
from repro_torch.models.zamba2 import ZambaCache

__all__ = ["serve", "serve_config", "prepare", "generate"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_config(arch: str, *, reduced: bool = True,
                 attention_impl: str | None = None,
                 param_dtype: str | None = None,
                 device: "str | torch.device | None" = None) -> ModelConfig:
    """The config ``prepare`` serves: ``arch``'s, reduced where asked, with
    ``attention_impl`` (default ``"kernel"`` on CUDA, the config's own on
    the CPU) and ``param_dtype`` (default: the config's) as both the
    parameter and the compute dtype."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    impl = attention_impl or ("kernel" if resolve_device(device).type
                              == "cuda" else cfg.attention_impl)
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype,
                                  compute_dtype=param_dtype)
    return cfg


def prepare(arch: str, *, batch: int = 4, prompt_len: int = 64,
            gen: int = 32, reduced: bool = True, seed: int = 0,
            attention_impl: str | None = None,
            param_dtype: str | None = None,
            device: "str | torch.device | None" = None
            ) -> tuple[Model, dict, dict,
                       "KVCache | RWKVState | ZambaCache", torch.Generator]:
    """The model of ``serve_config(arch, ...)``, random parameters, a
    random prompt batch and the family's empty cache of ``prompt_len + gen +
    DECODE_SLACK`` rows (the SSM family's state has no rows and ignores the
    length), all drawn from one generator seeded with ``seed`` on the
    device (returned for sampling)."""
    dev = resolve_device(device)
    cfg = serve_config(arch, reduced=reduced, attention_impl=attention_impl,
                       param_dtype=param_dtype, device=dev)
    model = build_model(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    params = model.init_params(g, device=dev)
    pb = make_batch(cfg, batch, prompt_len, generator=g, device=dev)
    cache = model.init_cache(batch, prompt_len + gen + DECODE_SLACK,
                             device=dev)
    return model, params, pb, cache, g


@torch.no_grad()
def generate(model: Model, params: dict, batch: dict,
             cache: "KVCache | RWKVState | ZambaCache", *,
             gen: int, temperature: float = 0.0,
             generator: torch.Generator | None = None) -> dict:
    """Prefill ``batch`` into ``cache``, then ``gen`` decode steps, greedy
    (``temperature == 0``) or sampled from ``generator``.  Returns the
    ``serve`` dict; the cache is filled in place."""
    dev = batch["tokens"].device
    b = batch["tokens"].shape[0]
    _sync(dev)
    t0 = time.monotonic()
    logits, cache = model.prefill(params, batch, cache)
    _sync(dev)
    t_prefill = time.monotonic() - t0

    def pick(logits):
        last = logits[:, -1].float()
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator).int()
        return last.argmax(-1, keepdim=True).int()

    tok = pick(logits)
    out_tokens = [tok]
    lat = []
    for _ in range(gen):
        t0 = time.monotonic()
        logits, cache = model.decode_step(params, tok, cache)
        _sync(dev)
        lat.append(time.monotonic() - t0)
        tok = pick(logits)
        out_tokens.append(tok)
    lat = np.asarray(lat)
    toks = torch.cat(out_tokens, dim=1).cpu().numpy()
    if int(toks.max()) >= model.cfg.vocab_size:
        raise AssertionError("padded-vocab token leaked")
    return {
        "prefill_s": t_prefill,
        "decode_p50_ms": float(np.percentile(lat, 50) * 1e3) if len(lat) else 0,
        "decode_p95_ms": float(np.percentile(lat, 95) * 1e3) if len(lat) else 0,
        "tokens_per_s": float(b * len(lat) / lat.sum()) if len(lat) else 0,
        "tokens": toks,
        "cache_len": int(cache.length),
    }


def serve(arch: str, *, batch: int = 4, prompt_len: int = 64, gen: int = 32,
          reduced: bool = True, seed: int = 0, temperature: float = 0.0,
          device: "str | torch.device | None" = None) -> dict:
    """Serve ``arch`` with random weights: prefill ``batch`` random prompts
    of ``prompt_len`` tokens, then decode ``gen`` tokens.  ``device``
    (default ``"cuda"``) is where it runs; without a CUDA device the default
    raises ``RuntimeError`` (pass ``device="cpu"``).

    Returns ``prefill_s``, ``decode_p50_ms``, ``decode_p95_ms``,
    ``tokens_per_s``, ``tokens`` (``[batch, gen + 1]``) and ``cache_len``,
    as the JAX package's ``serve``."""
    model, params, pb, cache, g = prepare(
        arch, batch=batch, prompt_len=prompt_len, gen=gen, reduced=reduced,
        seed=seed, device=device)
    return generate(model, params, pb, cache, gen=gen,
                    temperature=temperature, generator=g)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: reduced)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    out = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, temperature=args.temperature,
                reduced=not args.full, device=args.device)
    print(f"[serve] prefill {out['prefill_s']*1e3:.1f} ms; decode p50 "
          f"{out['decode_p50_ms']:.2f} ms p95 {out['decode_p95_ms']:.2f} ms; "
          f"{out['tokens_per_s']:.1f} tok/s; cache_len={out['cache_len']}")


if __name__ == "__main__":
    main()
