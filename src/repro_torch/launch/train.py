"""Fault-tolerant training loop.

The port of the JAX package's ``launch/train.py``: the training step
(``launch.steps.build_train_step``) under a supervisor loop with the Mez
fault philosophy (the paper's Section 4.4) on the training plane:

  * detection by timeout on the step itself (no separate heartbeat): a
    watchdog marks the step dead if it exceeds ``step_timeout``, timed to
    the end of the device work (``torch.cuda.synchronize``); a failure can
    be injected at one step (``inject_failure_at``);
  * recovery by restore from the newest valid checkpoint (CRC-validated,
    torn steps skipped), with the optimizer state re-initialised, as the
    JAX package's ``train`` does;
  * checkpoints every ``checkpoint_every`` steps.

With ``grad_bits < 16`` every gradient leaf of at least 1024 elements
takes the approximate collective's quantize round trip
(``make_grad_compressor``) before AdamW: on the card through the
hand-written quantize and dequantize kernels.  Attention trains through the
config's own impl (``"chunked"``), as the JAX package does: the flash kernel
has no backward.  ``mesh_shape`` (a multi-GPU mesh) waits for ROADMAP
Queue 1, fleet mesh and sharding.

Usage (on the card; add ``--device cpu`` to train the reduced config on
the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --steps 50 --batch 8 --seq 128 --checkpoint-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.approx_comm import make_grad_compressor
from repro_torch.data.pipeline import Prefetcher, TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_train_step
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

__all__ = ["StepWatchdog", "train", "main"]


class StepWatchdog:
    """Timeout-based failure detection for the training step."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self.failures = 0

    def run(self, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        if time.monotonic() - t0 > self.timeout_s:
            self.failures += 1
            raise TimeoutError(
                f"step exceeded {self.timeout_s}s (straggler/failed worker)")
        return out


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
          reduced: bool = True, checkpoint_dir: str | None = None,
          checkpoint_every: int = 20, restore: bool = False,
          grad_bits: int = 16, inject_failure_at: int = -1,
          step_timeout: float = 120.0, mesh_shape: tuple | None = None,
          seed: int = 0, log_every: int = 10,
          device: "str | torch.device | None" = None) -> dict:
    """Train ``arch`` with random weights drawn from ``seed`` on synthetic
    token batches (``TokenStream``), as the JAX ``train``: ``reduced``
    takes the smoke config with one microbatch.  ``device`` (default
    ``"cuda"``) is where it runs; without a CUDA device the default raises
    ``RuntimeError`` (pass ``device="cpu"``).

    Returns the JAX dict -- ``losses`` (one per executed step), ``steps``,
    ``wall_s``, ``first_loss``, ``final_loss`` -- plus ``device``, and
    what a run on the card is measured by: ``step_s`` (each executed
    step's wall seconds, ending in a synchronise), ``checkpoint_s`` (each
    save's seconds) and ``recoveries`` (``(failed step, resumed step)``
    pairs)."""
    if mesh_shape is not None:
        raise NotImplementedError(
            "mesh_shape: a multi-GPU mesh is not ported yet (ROADMAP Queue 1, "
            "fleet mesh and sharding); the port trains on one device")
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), train_microbatches=1)
    compressor = (make_grad_compressor(grad_bits, min_size=1024)
                  if grad_bits < 16 else None)
    step_fn = build_train_step(cfg, AdamWConfig(), grad_compress=compressor)
    model = build_model(cfg)

    def fresh_params():
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return model.init_params(g, device=dev)

    params = fresh_params()
    opt_state = init_opt_state(params, device=dev)
    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    start_step = 0
    if ckpt and restore and ckpt.latest_valid_step() is not None:
        params, start_step = ckpt.restore(params, device=dev)
        print(f"[train] restored params from step {start_step}")

    stream = Prefetcher(
        iter(TokenStream(cfg.vocab_size, batch, seq, seed=seed)), depth=2)
    watchdog = StepWatchdog(step_timeout)
    losses, step_s, checkpoint_s, recoveries = [], [], [], []
    t_start = time.time()
    step = start_step
    while step < steps:
        raw = next(stream)
        b = {k: torch.from_numpy(raw[k]).to(dev)
             for k in ("tokens", "labels")}
        try:
            if step == inject_failure_at:
                # simulated node failure mid-run
                raise TimeoutError("injected node failure")
            t0 = time.monotonic()
            params, opt_state, metrics = watchdog.run(step_fn, params,
                                                      opt_state, b)
            step_s.append(time.monotonic() - t0)
        except TimeoutError as e:
            print(f"[train] step {step} FAILED ({e}); recovering...")
            if ckpt is None:
                raise
            failed = step
            latest = ckpt.latest_valid_step()
            if latest is None:
                print("[train] no checkpoint; restarting from init")
                params, step = fresh_params(), 0
            else:
                params, step = ckpt.restore(params, device=dev)
                print(f"[train] resumed from checkpoint step {step}")
            opt_state = init_opt_state(params, device=dev)
            recoveries.append((failed, step))
            inject_failure_at = -1   # don't loop the injection
            continue
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0:
            print(f"[train] step {step} loss {loss:.4f}")
        if ckpt and step > 0 and step % checkpoint_every == 0:
            t0 = time.monotonic()
            ckpt.save(step, params, meta={"arch": arch, "loss": loss})
            checkpoint_s.append(time.monotonic() - t0)
        step += 1
    wall = time.time() - t_start
    return {"losses": losses, "steps": step - start_step, "wall_s": wall,
            "final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "device": str(dev), "step_s": step_s,
            "checkpoint_s": checkpoint_s, "recoveries": recoveries}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: reduced)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--grad-bits", type=int, default=16, choices=[16, 8, 4])
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    out = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                reduced=not args.full, checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every, restore=args.restore,
                grad_bits=args.grad_bits,
                inject_failure_at=args.inject_failure_at, device=args.device)
    print(f"[train] done on {out['device']}: {out['steps']} steps, "
          f"loss {out['first_loss']:.4f} -> {out['final_loss']:.4f}, "
          f"{out['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
