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
hand-written quantize and dequantize kernels.  Attention (and rwkv6's wkv
scan) trains through the config's own impl (``"chunked"``), as the JAX
package does: the flash and scan kernels have no backward.  Every family
trains: the VLM family's batch carries zero patch embeddings, the audio
family's seeded frame embeddings (``step_batch``).

``mesh_shape`` (``(data, model)`` or ``(pod, data, model)``) trains SPMD,
the torch way: each of ``prod(mesh_shape)`` processes calls ``train``
inside an initialised process group (NCCL on the card, one process a
card on ``cuda:<local rank>``, as ``torchrun`` launches them; gloo with
``device="cpu"`` in the tests), and the mesh is
``launch.mesh.make_mesh(mesh_shape, axes)`` over it.  Each rank stores
its parameters and both AdamW moments as its blocks per
``param_specs`` / ``opt_state_specs`` (``DTensor``s), and the step is
``launch.steps.build_sharded_train_step``: the rank's batch rows, its
blocks' DP-mean gradients, the gradient hook on the mean, AdamW on its
blocks.  For the dense, MoE and VLM families the step computes
partitioned over the model axis (each rank its heads, FFN columns,
experts and vocabulary block; each layer's FSDP blocks gathered over the
DP group inside the layer), so no whole parameter is held and activation
memory is divided by the model axis; rwkv6, zamba2 and the enc-dec family
gather their whole parameters and compute alike on the model axis's ranks
(their partitioned compute is still to port).  Sequence-parallel
attention is not ported.
Checkpoints stay whole arrays (rank 0 writes the gathered tree), and a
restore puts each rank's blocks back (``Checkpointer.restore(...,
shardings=)``).  A ``mesh_shape`` without a process group, or whose size
is not the world size, raises.

Usage (on the card; add ``--device cpu`` to train the reduced config on
the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --steps 50 --batch 8 --seq 128 --checkpoint-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch seamless-m4t-large-v2 --steps 5 --device cpu
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen3-1.7b --mesh 2,2
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.approx_comm import make_grad_compressor
from repro_torch.data.pipeline import Prefetcher, TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (build_sharded_train_step,
                                      build_train_step)
from repro_torch.models import registry
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.sharding import partition, spmd

__all__ = ["StepWatchdog", "step_batch", "train", "main"]


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


def step_batch(cfg, raw: dict, step: int, dev: torch.device) -> dict:
    """Step ``step``'s batch, as the JAX ``train`` builds it from the
    stream's ``tokens`` / ``labels`` ``[batch, seq]``: the VLM family adds
    zero patch embeddings ``[batch, frontend_tokens, d_model]``, the audio
    family frame embeddings ``[batch, seq, d_model]`` drawn from
    ``np.random.default_rng(step).normal(0, 0.02, ...)``; both float32."""
    b = {k: torch.from_numpy(raw[k]).to(dev) for k in ("tokens", "labels")}
    n = raw["tokens"].shape[0]
    if cfg.family == "vlm":
        b["patch_embeds"] = torch.zeros((n, cfg.frontend_tokens, cfg.d_model),
                                        dtype=torch.float32, device=dev)
    if cfg.family == "audio":
        b["embeds"] = torch.from_numpy(np.random.default_rng(step).normal(
            0, 0.02, (n, raw["tokens"].shape[1], cfg.d_model)).astype(
                np.float32)).to(dev)
    return b


MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _rank_device(device) -> torch.device:
    """A rank's device: ``device`` when given, else ``cuda:<LOCAL_RANK>``
    (torchrun's variable; the global rank modulo the card count
    without it)."""
    if device is not None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
        local = dist.get_rank() % max(1, n)
    return resolve_device(f"cuda:{int(local)}")


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
          reduced: bool = True, checkpoint_dir: str | None = None,
          checkpoint_every: int = 20, restore: bool = False,
          grad_bits: int = 16, inject_failure_at: int = -1,
          step_timeout: float = 120.0, mesh_shape: tuple | None = None,
          seed: int = 0, log_every: int = 10,
          device: "str | torch.device | None" = None,
          return_params: bool = False,
          opt: AdamWConfig | None = None) -> dict:
    """Train ``arch`` with random weights drawn from ``seed`` on synthetic
    token batches (``TokenStream``, with each family's extra inputs:
    ``step_batch``), as the JAX ``train``: ``reduced`` takes the smoke
    config with one microbatch.  ``device`` (default
    ``"cuda"``) is where it runs; without a CUDA device the default raises
    ``RuntimeError`` (pass ``device="cpu"``).  With ``mesh_shape`` every
    rank of the initialised process group calls ``train`` alike (see the
    module docstring); ``device`` defaults to ``cuda:<local rank>``.
    ``opt`` is AdamW's settings (default ``AdamWConfig()``).

    Returns the JAX dict -- ``losses`` (one per executed step), ``steps``,
    ``wall_s``, ``first_loss``, ``final_loss`` -- plus ``device``, and
    what a run on the card is measured by: ``step_s`` (each executed
    step's wall seconds, ending in a synchronise), ``checkpoint_s`` (each
    save's seconds) and ``recoveries`` (``(failed step, resumed step)``
    pairs).  On a mesh also ``mesh`` and ``resident`` (the parameter and
    moment elements this rank stores); with ``return_params`` also
    ``params``, the final whole parameters (gathered on a mesh)."""
    cfg = get_config(arch)
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), train_microbatches=1)
    compressor = (make_grad_compressor(grad_bits, min_size=1024)
                  if grad_bits < 16 else None)
    model = build_model(cfg)
    mesh = shardings = None
    rank0 = True
    if mesh_shape is None:
        dev = resolve_device(device)
        step_fn = build_train_step(cfg, opt, grad_compress=compressor)
    else:
        mesh_shape = tuple(int(n) for n in mesh_shape)
        if len(mesh_shape) not in MESH_AXES:
            raise ValueError(f"mesh_shape {mesh_shape}: (data, model) or "
                             "(pod, data, model)")
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("train(mesh_shape=...) runs one process a "
                               "rank inside an initialised process group; "
                               "none is initialised")
        dev = _rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = make_mesh(mesh_shape, MESH_AXES[len(mesh_shape)],
                         device_type=dev.type)
        rank0 = dist.get_rank() == 0
        shardings = partition.logical_to_sharding(partition.param_specs(
            registry.param_specs(cfg), cfg, mesh), mesh)
        step_fn = build_sharded_train_step(cfg, mesh, opt, compressor)
    say = print if rank0 else (lambda *a, **k: None)

    def fresh_params():
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        params = model.init_params(g, device=dev)
        return params if mesh is None else spmd.shard_tree(params, shardings)

    def fresh_opt(params):
        if mesh is None:
            return init_opt_state(params, device=dev)
        return {"m": spmd.zeros_like_tree(params),
                "v": spmd.zeros_like_tree(params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def restore_from(ckpt, params):
        return ckpt.restore(params, device=dev, shardings=shardings)

    params = fresh_params()
    opt_state = fresh_opt(params)
    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    start_step = 0
    if ckpt and restore and ckpt.latest_valid_step() is not None:
        params, start_step = restore_from(ckpt, params)
        say(f"[train] restored params from step {start_step}")

    stream = Prefetcher(
        iter(TokenStream(cfg.vocab_size, batch, seq, seed=seed)), depth=2)
    watchdog = StepWatchdog(step_timeout)
    losses, step_s, checkpoint_s, recoveries = [], [], [], []
    t_start = time.time()
    step = start_step
    while step < steps:
        b = step_batch(cfg, next(stream), step, dev)
        try:
            if step == inject_failure_at:
                # simulated node failure mid-run
                raise TimeoutError("injected node failure")
            t0 = time.monotonic()
            params, opt_state, metrics = watchdog.run(step_fn, params,
                                                      opt_state, b)
            step_s.append(time.monotonic() - t0)
        except TimeoutError as e:
            say(f"[train] step {step} FAILED ({e}); recovering...")
            if ckpt is None:
                raise
            failed = step
            latest = ckpt.latest_valid_step()
            if latest is None:
                say("[train] no checkpoint; restarting from init")
                params, step = fresh_params(), 0
            else:
                params, step = restore_from(ckpt, params)
                say(f"[train] resumed from checkpoint step {step}")
            opt_state = fresh_opt(params)
            recoveries.append((failed, step))
            inject_failure_at = -1   # don't loop the injection
            continue
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0:
            say(f"[train] step {step} loss {loss:.4f}")
        if ckpt and step > 0 and step % checkpoint_every == 0:
            t0 = time.monotonic()
            # the checkpoint holds whole arrays: a mesh gathers them, rank
            # 0 writes, and every rank waits for the step to be published
            whole = params if mesh is None else spmd.full_tree(params)
            if rank0:
                ckpt.save(step, whole, meta={"arch": arch, "loss": loss})
            del whole
            if mesh is not None:
                dist.barrier()
            checkpoint_s.append(time.monotonic() - t0)
        step += 1
    wall = time.time() - t_start
    out = {"losses": losses, "steps": step - start_step, "wall_s": wall,
           "final_loss": losses[-1] if losses else None,
           "first_loss": losses[0] if losses else None,
           "device": str(dev), "step_s": step_s,
           "checkpoint_s": checkpoint_s, "recoveries": recoveries}
    if mesh is not None:
        out["mesh"] = list(mesh_shape)
        out["resident"] = {
            "params": spmd.resident_elements(params),
            "moments": (spmd.resident_elements(opt_state["m"])
                        + spmd.resident_elements(opt_state["v"]))}
    if return_params:
        out["params"] = params if mesh is None else spmd.full_tree(params)
    return out


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
    ap.add_argument("--mesh", default=None,
                    help="data,model or pod,data,model: train SPMD, one "
                         "process a rank (launch with torchrun)")
    args = ap.parse_args()
    mesh_shape = None
    if args.mesh:
        mesh_shape = tuple(int(n) for n in args.mesh.split(","))
        dist.init_process_group("nccl" if args.device in (None, "cuda")
                                else "gloo")
    out = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                reduced=not args.full, checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every, restore=args.restore,
                grad_bits=args.grad_bits,
                inject_failure_at=args.inject_failure_at, device=args.device,
                mesh_shape=mesh_shape)
    if mesh_shape is not None:
        dist.destroy_process_group()
    print(f"[train] done on {out['device']}: {out['steps']} steps, "
          f"loss {out['first_loss']:.4f} -> {out['final_loss']:.4f}, "
          f"{out['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
