"""The dry-run on one card: every (arch x shape) cell accounted on the meta
device.

The port of the JAX package's ``launch/dryrun.py``.  There, each cell's
step is lowered and compiled (``jax.jit(...).lower().compile()``) for a
mesh of TPU chips, and XLA's memory and cost analyses are recorded.  Here
each cell's step runs once on tensors on ``torch.device("meta")``, which
have shapes and dtypes but no storage: nothing is allocated and nothing
is computed, and the run is the counterpart of the lowering.  A dispatch
mode, ``MetaPass``, watches it:

  * the peak of the bytes the step's own tensors hold while it runs (its
    temporaries, saved activations and outputs; storages it writes in
    place are its inputs'), the counterpart of XLA's temp bytes;
  * the FLOPs of the step's matrix products, by the formulas of
    ``torch.utils.flop_counter`` (``FlopCounterMode``'s), the counterpart
    of XLA's cost analysis, and beside them that analysis's other two
    figures under its names: ``bytes_accessed``, the bytes every
    operation reads and writes, and ``transcendentals``, the elements of
    the step's exp, log, tanh, sigmoid, silu, softplus, gelu, erf, sin,
    cos, rsqrt, sqrt and (log-)softmax and their backward ops
    (``meta.TRANSCENDENTAL``).  XLA counts them for a fused program: a
    fusion reads its inputs and writes its outputs once, and what stays
    inside it moves nothing.  The port counts each eager operation's own
    traffic, every intermediate written by one op and read by the next,
    so its bytes are an upper bound on what a fused step moves; its
    transcendentals are XLA's count for the same functions (one per
    output element; an rms norm's one rsqrt a row).

The meta pass runs the plain routes (``"chunked"`` attention, the einsum
decode, ``wkv_plain``): the kernels take only card tensors, and their
temporaries are smaller than the plain routes', so the reckoning is an
upper bound for a kernel run.  A train cell runs ``build_train_bundle``
(microbatches by ``microbatch_count`` at a data-parallel size of 1, the
backward under ``remat="full"``, AdamW) on meta too.

Per cell, ``<out>/<arch>__<shape>.json`` (written as each cell ends; a
cell whose file says ``ok`` is kept unless ``--force``):

  param_bytes, opt_state_bytes (train cells), input_bytes (the batch, or
  the tokens and the cache), output_bytes (output_new_bytes: those not in
  the arguments' storages), peak_temp_bytes, total_bytes (parameters,
  state, inputs and peak temporaries), flops, bytes_accessed,
  transcendentals, fits_one_card (total_bytes
  within ``H100.hbm_bytes``), cut (``find_cut``: the largest batch that
  fits at full depth or, where none does, the largest depth at the
  smallest batch: ``{"global_batch", "num_layers", "total_bytes"}``, null
  if not even one layer fits), seconds.

With ``--device cuda`` each cell's cut then runs once on the card through
the kernel routes (``"kernel"``; a train cell through the config's own),
from random weights drawn from a seeded generator and, for a decode cell,
a cache of random keys and values at ``length = seq_len``, held against
the same step on the plain routes (``card_compare``, the comparison
``chip_smoke.py``'s dryrun phase makes); the record gains ``card``
(seconds, the measured step bytes beside the reckoning, the relative
errors).

With ``--mesh single|multi|both`` each cell is accounted instead as JAX
accounts it, for one device of the production mesh, ``(16, 16)``
(``single``) and ``(2, 16, 16)`` (``multi``): the step is one rank's
(``launch/steps.py`` on a ``DeviceMesh``: its blocks, its batch rows, its
collectives), run on meta tensors over a fake process group of 256 or 512
ranks in this process (``launch.mesh.fake_mesh``; rank 0), and
``<out>/<arch>__<shape>__<mesh>.json`` holds, as JAX's record does:

  devices; memory.{argument_bytes (the rank's blocks of the arguments),
  output_bytes, temp_bytes (the peak of the step's own tensors),
  alias_bytes (outputs in the arguments' storages: the donated cache, or
  the parameters and moments AdamW writes)}; cost.{flops,
  bytes_accessed, transcendentals} of the rank's step; collectives:
  ``{kind: {"bytes", "count"}}`` for all-gather, all-reduce,
  reduce-scatter, all-to-all and collective-permute (output bytes, as
  ``parse_collectives`` records them; ``MetaPass`` counts them); and
  model_axis: ``"compute"``, the model axis partitioning the step's
  products (every family); fits: argument plus temp bytes within
  ``H100.hbm_bytes``.  All of it is a reckoning on the meta device, not a
  measurement.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
      [--shape S] [--out DIR] [--force] [--device meta|cuda]
      [--mesh single|multi|both] [--jobs N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, as_completed

import torch

from repro_torch.configs import (ARCHS, SHAPE_CELLS, ModelConfig, ShapeCell,
                                 cells_for, get_config, skipped_cells_for)
from repro_torch.launch.mesh import H100, fake_production_mesh
from repro_torch.launch.steps import (StepBundle, build_prefill_step,
                                      build_serve_step, build_train_bundle,
                                      local_specs, microbatch_count,
                                      model_axis)
from repro_torch.meta import META, MetaPass, distinct_bytes, tensors_of
from repro_torch.models.registry import DECODE_SLACK, build_model, make_batch
from repro_torch.optim.adamw import init_opt_state

__all__ = ["cell_bundle", "depth_cut", "account", "account_mesh",
           "argument_bytes",
           "find_cut", "run_cell", "run_mesh_cell", "card_args", "card_run",
           "card_compare", "written", "rel_rms", "main", "MESHES"]

MESHES = ("single", "multi")

PLAIN_IMPL = "chunked"      # the meta pass's routes
KERNEL_IMPL = "kernel"      # the card's
PLAIN_WKV_CHUNK = 64        # wkv_plain's chunk in a plain step on the card
# a kernel step against the plain step, bfloat16 end to end: logits (the
# real vocabulary's columns) and what the step writes into the cache within
# 2^-4 relative (Frobenius).  The two routes' attention (or scan) outputs
# round apart by about a bf16 step (2^-8) and 24-36 bf16 layers carry that
# on: 1.3-4.4% on the H100 at the dryrun phase's cuts.  A planted fault in
# every launch read 77% (qwen3's decode, its last split skipped) and
# 99-111% (rwkv6's scan, a chunk or the state misread); it cannot see a
# fault that moves a step less than the rounding does (zamba2's skipped
# split, 2.2% against 2.0%; qwen3's misread last key tile, 5.7%): a
# kernel's own faults are held launch by launch (chip_smoke.py).
STEP_RTOL = 2.0 ** -4


def depth_cut(cfg: ModelConfig, num_layers: int) -> ModelConfig:
    """``cfg`` cut to ``num_layers`` (an enc-dec config's encoder and
    decoder each), the widths kept."""
    return dataclasses.replace(
        cfg, num_layers=min(num_layers, cfg.num_layers),
        num_decoder_layers=min(num_layers, cfg.num_decoder_layers))


def cell_bundle(cfg: ModelConfig, cell: ShapeCell, *,
                impl: "str | None" = PLAIN_IMPL,
                device: "torch.device | str" = META,
                mesh=None) -> StepBundle:
    """The step of ``cell``: ``build_prefill_step`` / ``build_serve_step``
    with ``impl``, or for a train cell ``build_train_bundle`` (the
    config's own attention impl: the kernels have no backward) with meta
    parameters, AdamW state and batch.  On a ``DeviceMesh`` one rank's
    step over its blocks."""
    if cell.kind == "prefill":
        return build_prefill_step(cfg, cell, impl=impl, device=device,
                                  mesh=mesh)
    if cell.kind == "decode":
        return build_serve_step(cfg, cell, impl=impl, device=device,
                                mesh=mesh)
    return build_train_bundle(cfg, cell, device=device, mesh=mesh)


def account(cfg: ModelConfig, cell: ShapeCell, *,
            memo: "dict | None" = None) -> dict:
    """One meta pass of ``cell``'s step on its plain routes: the bytes of
    its arguments, outputs and peak temporaries, their total, the FLOPs of
    its matrix products, and the bytes its operations read and write and
    their transcendentals (``MetaPass``, with ``memo``)."""
    bundle = cell_bundle(cfg, cell)
    args = bundle.arg_specs
    rec = {"param_bytes": distinct_bytes(args[0])}
    if cell.kind == "train":
        rec["opt_state_bytes"] = distinct_bytes(args[1])
    rec["input_bytes"] = distinct_bytes(args[1 if cell.kind != "train"
                                             else 2:])
    watch = MetaPass(exclude=args, memo=memo)
    with watch:
        out = bundle.fn(*args)
    arg_keys = {t.untyped_storage()._cdata for t in tensors_of(args)}
    rec["output_bytes"] = distinct_bytes(out)
    rec["output_new_bytes"] = distinct_bytes(
        [t for t in tensors_of(out)
         if t.untyped_storage()._cdata not in arg_keys])
    rec["peak_temp_bytes"] = watch.peak
    rec["total_bytes"] = (rec["param_bytes"] + rec.get("opt_state_bytes", 0)
                          + rec["input_bytes"] + watch.peak)
    rec["flops"] = watch.flops
    rec["bytes_accessed"] = watch.bytes_accessed
    rec["transcendentals"] = watch.transcendentals
    return rec


def argument_bytes(cfg: ModelConfig, cell: ShapeCell, mesh) -> int:
    """The bytes of one rank's arguments of ``cell``'s step on ``mesh``
    (an ``AbstractMesh`` will do: no pass, no process group): every leaf
    of the step's whole arguments at its local shape per the bundle's
    ``in_shardings`` (a cache's host-side ``length`` holds none)."""
    bundle = cell_bundle(cfg, cell, mesh=mesh)
    return distinct_bytes(local_specs(bundle.arg_specs, bundle.in_shardings,
                                      mesh))


def account_mesh(cfg: ModelConfig, cell: ShapeCell, mesh, *,
                 memo: "dict | None" = None) -> dict:
    """One meta pass of one rank's step of ``cell`` on ``mesh`` (a
    ``DeviceMesh``, the fake production mesh in the dry-run), on the plain
    routes: JAX's record's ``memory``, ``cost`` and ``collectives`` (see
    the module docstring), and ``model_axis``."""
    bundle = cell_bundle(cfg, cell, mesh=mesh)
    args = bundle.arg_specs
    watch = MetaPass(exclude=args, memo=memo)
    with watch:
        out = bundle.fn(*args)
    arg_keys = {t.untyped_storage()._cdata for t in tensors_of(args)}
    out_bytes = distinct_bytes(out)
    new_bytes = distinct_bytes([t for t in tensors_of(out)
                                if t.untyped_storage()._cdata not in arg_keys])
    return {"devices": mesh.size(), "model_axis": model_axis(cfg),
            "memory": {"argument_bytes": distinct_bytes(args),
                       "output_bytes": out_bytes,
                       "temp_bytes": watch.peak,
                       "alias_bytes": out_bytes - new_bytes},
            "cost": {"flops": watch.flops,
                     "bytes_accessed": watch.bytes_accessed,
                     "transcendentals": watch.transcendentals},
            "collectives": watch.collectives}


def run_mesh_cell(arch: str, shape: str, mesh_kind: str) -> dict:
    """``account_mesh`` of one cell for rank 0 of the fake production mesh
    (``mesh_kind`` ``"single"``: 256 ranks, ``"multi"``: 512), with JAX's
    record's keys and ``fits`` (argument plus temp bytes within
    ``H100.hbm_bytes``)."""
    cell = SHAPE_CELLS[shape]
    t0 = time.monotonic()
    with fake_production_mesh(multi_pod=mesh_kind == "multi") as mesh:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "ok": True,
               "mesh_shape": list(mesh.mesh.shape),
               **account_mesh(get_config(arch), cell, mesh)}
    mem = rec["memory"]
    rec["device_bytes"] = mem["argument_bytes"] + mem["temp_bytes"]
    rec["fits"] = rec["device_bytes"] <= H100.hbm_bytes
    rec["budget_bytes"] = H100.hbm_bytes
    rec["seconds"] = time.monotonic() - t0
    return rec


def _largest(total, hi: int, budget: float) -> int:
    """The largest n in [1, hi) with ``total(n) <= budget`` (0 if none),
    where ``hi`` does not fit and the bytes grow with n.  It probes 1 and
    2, then the guess of the line through them: a guess that fits and
    lies on the line to the byte is the answer (its neighbour lies on the
    line above the budget), as it is when the bytes grow linearly -- a
    cell's do in batch, and in depth counted in whole layers (or shared
    blocks).  Anything else is bisected between the largest probe that
    fits and the smallest that does not."""
    f1 = total(1)
    if f1 > budget:
        return 0
    if hi <= 2:
        return 1
    f2 = total(2)
    if f2 > budget:
        return 1
    lo, slope = 2, f2 - f1
    if slope > 0:
        n = min(hi - 1, 1 + int((budget - f1) // slope))
        if n > 2:
            f = total(n)
            if f > budget:
                hi = n
            elif f == f1 + slope * (n - 1):
                return n
            else:
                lo = n
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if total(mid) <= budget:
            lo = mid
        else:
            hi = mid
    return lo


def _floor_bytes(cfg: ModelConfig, cell: ShapeCell) -> int:
    """What ``cell``'s step holds whatever its temporaries, with no pass:
    its arguments, and a train step's float32 gradient sums where it
    splits the batch into microbatches."""
    args = cell_bundle(cfg, cell).arg_specs
    n = distinct_bytes(args)
    if cell.kind == "train" and microbatch_count(cfg,
                                                 cell.global_batch) > 1:
        n += 4 * sum(t.numel() for t in tensors_of(args[0]))
    return n


def find_cut(cfg: ModelConfig, cell: ShapeCell, full_total: int, *,
             budget: float = H100.hbm_bytes,
             memo: "dict | None" = None) -> "dict | None":
    """The cell cut to fit ``budget``: the largest global batch at full
    depth (a train cell's in whole multiples of its microbatch count, so
    the step keeps its microbatches), else at that smallest batch the
    largest depth (in whole super-blocks for the hybrid family, whose
    shared block comes every ``shared_attn_period`` layers); ``None``
    where one layer (or super-block) does not fit.  Each candidate is
    reckoned by its own meta pass (``_largest``)."""
    if full_total <= budget:
        return {"global_batch": cell.global_batch,
                "num_layers": cfg.num_layers, "total_bytes": full_total}
    step = max(1, cfg.train_microbatches) if cell.kind == "train" else 1
    units = cell.global_batch // step
    seen: dict = {}

    def at(batch_units: int, layers: int) -> int:
        if (batch_units, layers) not in seen:
            c = dataclasses.replace(cell, global_batch=batch_units * step)
            seen[batch_units, layers] = account(
                depth_cut(cfg, layers), c, memo=memo)["total_bytes"]
        return seen[batch_units, layers]

    smallest = dataclasses.replace(cell, global_batch=step)
    if units > 1 and _floor_bytes(cfg, smallest) <= budget:
        k = _largest(lambda k: at(k, cfg.num_layers), units, budget)
        if k:
            return {"global_batch": k * step, "num_layers": cfg.num_layers,
                    "total_bytes": at(k, cfg.num_layers)}
    per = cfg.shared_attn_period if cfg.family == "hybrid" else 1
    hi = cfg.num_layers // per + (1 if cfg.num_layers % per else 0)
    j = _largest(lambda j: at(1, j * per), hi, budget)
    if not j:
        return None
    return {"global_batch": step, "num_layers": j * per,
            "total_bytes": at(1, j * per)}


def card_args(cfg: ModelConfig, bundle: StepBundle, cell: ShapeCell,
              generator: torch.Generator) -> tuple:
    """Real arguments on ``bundle.device`` for the shapes of
    ``bundle.arg_specs``, drawn from ``generator``: parameters by
    ``init_params``, a batch by ``make_batch`` (a decode step's tokens
    uniform in the vocabulary), a prefill's cache zero, a decode cell's
    cache unit normal (keys, values and states) at its spec's ``length =
    seq_len``, a train cell's AdamW state zero."""
    dev = bundle.device
    specs = bundle.arg_specs

    def normal(spec: torch.Tensor) -> torch.Tensor:
        out = torch.empty(spec.shape, dtype=spec.dtype, device=dev)
        flat = out.view(-1)
        for i in range(0, flat.numel(), 1 << 26):  # float32 blocks, 256 MB
            n = min(1 << 26, flat.numel() - i)
            flat[i:i + n] = torch.randn(n, generator=generator, device=dev)
        return out

    def cache(spec, fill):
        return dataclasses.replace(spec, **{
            f.name: cache(v, fill) if dataclasses.is_dataclass(v) else fill(v)
            for f in dataclasses.fields(spec)
            if not isinstance(v := getattr(spec, f.name), int)})

    params = build_model(cfg).init_params(generator, device=dev)
    if cell.kind == "decode":
        tokens = torch.randint(0, cfg.vocab_size, specs[1].shape,
                               generator=generator, device=dev,
                               dtype=specs[1].dtype)
        return params, tokens, cache(specs[2], normal)
    batch = make_batch(cfg, cell.global_batch, cell.seq_len,
                       generator=generator, device=dev,
                       train=cell.kind == "train")
    if cell.kind == "train":
        return params, init_opt_state(params, device=dev), batch
    return params, batch, cache(specs[2], lambda t: torch.zeros(
        t.shape, dtype=t.dtype, device=dev))


def card_run(cfg: ModelConfig, cell: ShapeCell, *, impl: "str | None",
             generator: torch.Generator, args: "tuple | None" = None,
             device: "torch.device | str" = "cuda") -> dict:
    """``cell``'s step once on the card with ``impl`` (``None``: the
    config's own): its outputs (``out``), wall seconds ending in a
    synchronise, ``torch.cuda.max_memory_allocated`` during the step and
    ``step_bytes``: the arguments' bytes plus that peak over what was
    allocated before the step, the measured counterpart of a meta pass's
    ``total_bytes``.
    ``args`` (else ``card_args`` from ``generator``) are the step's
    inputs.  ``device``: the card (a CPU rehearsal passes ``"cpu"``)."""
    bundle = cell_bundle(cfg, cell, impl=impl, device=device)
    if args is None:
        args = card_args(cfg, bundle, cell, generator)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with torch.set_grad_enabled(cell.kind == "train"):
        out = bundle.fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"out": out, "seconds": time.monotonic() - t0,
            "max_memory_allocated": peak,
            "step_bytes": distinct_bytes(args) + peak - base}


def written(cache, cell: ShapeCell, rows: "int | None" = None, *,
            states: bool = False) -> dict:
    """What a step of ``cell`` wrote into ``cache`` (a step's returned
    cache), by leaf path: of each key/value cache (``[L, B, S_max, KH,
    D]``) the row a decode step wrote (``[:, :, length - 1]``) or the rows
    a prefill filled (``[:, :rows, :S]``), every other leaf (the recurrent
    states ``[L, B, ...]``, an encoder output ``[B, S, D]``) whole or its
    first ``rows`` batch rows.  With ``states`` only those others,
    whole."""
    s_max = cell.seq_len + DECODE_SLACK
    out = {}

    def walk(node, prefix):
        for f in dataclasses.fields(node):
            t = getattr(node, f.name)
            if dataclasses.is_dataclass(t):
                walk(t, f"{prefix}{f.name}/")
            elif not isinstance(t, int):
                kv = t.dim() == 5 and t.shape[2] == s_max
                enc = t.dim() == 3 and t.shape[1] == cell.seq_len
                if states and kv:
                    continue
                if cell.kind == "decode" or states:
                    out[prefix + f.name] = t[:, :, node.length - 1] if kv \
                        else t
                elif kv:
                    out[prefix + f.name] = t[:, :rows, :cell.seq_len]
                else:
                    out[prefix + f.name] = t[:rows] if enc else t[:, :rows]
    walk(cache, "")
    return out


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| (Frobenius), in float32."""
    got, want = got.float(), want.float()
    norm = torch.linalg.vector_norm
    return float(norm(got - want) / norm(want).clamp_min(1e-30))


def card_compare(cfg: ModelConfig, cell: ShapeCell, args: tuple, *,
                 rows: int = 1, device: "torch.device | str" = "cuda"
                 ) -> dict:
    """A prefill or decode cell's step on the card through the kernel
    routes from ``args`` (``card_args``), then through the plain routes
    (``chunked``, the einsum decode, ``wkv_plain`` at chunk
    ``PLAIN_WKV_CHUNK``) from the same parameters and inputs: a decode
    step on the whole batch, its recurrent states put back first (the step
    writes them in place); a prefill on its first ``rows`` prompts into a
    fresh cache (its plain attention and scan read seconds of float32
    temporaries at S = 32768).  Returns the two runs (``card_run``'s
    records: ``kernel``, ``plain``), the plain step's ``plain_cfg`` /
    ``plain_cell`` and ``rows``, the logits (the real vocabulary's
    columns) and what each step wrote (``written``) on those rows
    (``got``, ``want``), their relative RMS (``rel_rms``, held within
    ``STEP_RTOL`` by the caller), ``again()``: the arguments of another
    step on the plain step's rows, and ``outputs(step_out)``: its
    ``got``-like outputs."""
    params, inp, cache = args
    kept = {k: t.clone() for k, t in written(cache, cell, states=True)
            .items()}
    run = card_run(cfg, cell, impl=KERNEL_IMPL, generator=None, args=args,
                   device=device)
    decode = cell.kind == "decode"
    rows = cell.global_batch if decode else rows
    pcfg, pcell = cfg, cell
    if not decode:
        pcell = dataclasses.replace(cell, global_batch=rows)
        if cfg.family == "ssm":
            pcfg = dataclasses.replace(cfg, attention_chunk=PLAIN_WKV_CHUNK)
    vocab = cfg.vocab_size          # the padded columns hold NEG_INF

    def outputs(step_out) -> dict:
        logits, new = step_out
        out = {"logits": logits[:rows, ..., :vocab],
               **written(new, pcell, rows)}
        # the next decode steps write the same rows
        return {k: t.clone() for k, t in out.items()} if decode else out

    def again() -> tuple:
        if decode:
            for k, t in written(cache, cell, states=True).items():
                t.copy_(kept[k])
            return params, inp, cache
        enc = {"enc_len": cell.seq_len} if cfg.family == "audio" else {}
        return (params, {k: v[:rows] for k, v in inp.items()},
                build_model(cfg).init_cache(
                    rows, cell.seq_len + DECODE_SLACK, device=device, **enc))

    got = outputs(run["out"])
    plain = card_run(pcfg, pcell, impl=PLAIN_IMPL, generator=None,
                     args=again(), device=device)
    want = outputs(plain["out"])
    return {"kernel": run, "plain": plain, "plain_cfg": pcfg,
            "plain_cell": pcell, "rows": rows, "got": got, "want": want,
            "rel_rms": {k: rel_rms(t, want[k]) for k, t in got.items()},
            "again": again, "outputs": outputs}


def _card_record(cfg: ModelConfig, cell: ShapeCell, cut: dict) -> dict:
    """``cell`` at ``cut`` once on the card, beside the meta pass's
    reckoning of the same cut (its plain routes hold larger temporaries
    than the kernels): a prefill or decode cell through ``card_compare``,
    its kernel step within ``STEP_RTOL`` of the plain step (else it
    raises); a train cell through its config's own routes (the kernels
    have no backward), its loss finite."""
    cfg = depth_cut(cfg, cut["num_layers"])
    cell = dataclasses.replace(cell, global_batch=cut["global_batch"])
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    if cell.kind == "train":
        run = card_run(cfg, cell, impl=None, generator=g)
        rec = {"finite": bool(torch.isfinite(run["out"][2]["loss"]).all())}
    else:
        args = card_args(cfg, cell_bundle(cfg, cell, impl=KERNEL_IMPL,
                                          device="cuda"), cell, g)
        both = card_compare(cfg, cell, args)
        run = both["kernel"]
        rec = {"plain_rows": both["rows"], "rel_rms_err": both["rel_rms"],
               "plain_step_bytes": both["plain"]["step_bytes"]}
        del args, both
    rec.update(seconds=run["seconds"], step_bytes=run["step_bytes"],
               reckoned_bytes=cut["total_bytes"])
    del run
    torch.cuda.empty_cache()
    off = {k: e for k, e in rec.get("rel_rms_err", {}).items()
           if not e <= STEP_RTOL}
    if off or not rec.get("finite", True):
        raise AssertionError(f"kernel step off the plain step: {rec}")
    return rec


def run_cell(arch: str, shape: str, *, device: str = "meta",
             reduced: bool = False) -> dict:
    """Account one cell on the meta device (``reduced``: at the config's
    reduced widths) and, with ``device="cuda"``, run its cut on the card."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cell = SHAPE_CELLS[shape]
    t0 = time.monotonic()
    memo: dict = {}
    rec = {"arch": arch, "shape": shape, "device": device, "ok": True,
           "reduced": reduced, "global_batch": cell.global_batch,
           "seq_len": cell.seq_len, "num_layers": cfg.num_layers,
           **account(cfg, cell, memo=memo)}
    rec["fits_one_card"] = rec["total_bytes"] <= H100.hbm_bytes
    rec["cut"] = find_cut(cfg, cell, rec["total_bytes"], memo=memo)
    rec["budget_bytes"] = H100.hbm_bytes
    if device == "cuda" and rec["cut"] is not None:
        rec["card"] = _card_record(cfg, cell, rec["cut"])
    rec["seconds"] = time.monotonic() - t0
    return rec


def _run_cell_safely(arch: str, shape: str, device: str,
                     mesh_kind: "str | None" = None) -> dict:
    """``run_cell`` (or ``run_mesh_cell`` with ``mesh_kind``), a failure
    recorded rather than raised (a pool worker's entry point)."""
    try:
        if mesh_kind is not None:
            return run_mesh_cell(arch, shape, mesh_kind)
        return run_cell(arch, shape, device=device)
    except Exception as e:  # noqa: BLE001 - report, keep going
        return {"arch": arch, "shape": shape, "device": device,
                "mesh": mesh_kind, "ok": False, "error": repr(e),
                "traceback": traceback.format_exc()[-4000:]}


def _tag(result: dict) -> str:
    tag = f"{result['arch']}__{result['shape']}"
    return tag + (f"__{result['mesh']}" if result.get("mesh") else "")


def _report(result: dict, path: str) -> None:
    tag = _tag(result)
    with open(path, "w") as fh:
        json.dump(result, fh, indent=1)
    if not result["ok"]:
        print(f"FAIL {tag}: {result['error']}", flush=True)
        return
    if result.get("mesh"):
        mem = result["memory"]
        coll = {k: f"{v['count']}x{v['bytes'] / 1e6:.1f}MB"
                for k, v in result["collectives"].items() if v["count"]}
        print(f"  ok {tag}: {result['seconds']:.1f}s "
              f"{result['model_axis']} "
              f"args={mem['argument_bytes'] / 1e9:.2f}GB "
              f"temp={mem['temp_bytes'] / 1e9:.2f}GB "
              f"fits={result['fits']} "
              f"flops={result['cost']['flops']:.3e} coll={coll}",
              flush=True)
        return
    cut = result["cut"]
    card = result.get("card")
    print(f"  ok {tag}: {result['seconds']:.1f}s "
          f"flops={result['flops']:.3e} "
          f"bytes_accessed={result['bytes_accessed']:.3e} "
          f"transcendentals={result['transcendentals']:.3e} "
          f"params={result['param_bytes'] / 1e9:.2f}GB "
          f"total={result['total_bytes'] / 1e9:.2f}GB "
          f"fits={result['fits_one_card']} cut="
          + (f"B{cut['global_batch']}xL{cut['num_layers']}"
             f"({cut['total_bytes'] / 1e9:.2f}GB)" if cut else "none")
          + (f" card={card['seconds']:.2f}s "
             f"{card['step_bytes'] / 1e9:.2f}GB" if card else ""),
          flush=True)


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"])
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the meta passes (meta only)")
    ap.add_argument("--mesh", default=None,
                    choices=["single", "multi", "both"],
                    help="account one device of the production mesh(es)")
    args = ap.parse_args(argv)
    if args.mesh and args.device != "meta":
        raise SystemExit("dryrun: --mesh accounts on the meta device")
    meshes = ([None] if args.mesh is None else
              list(MESHES) if args.mesh == "both" else [args.mesh])
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: --device cuda needs a CUDA device")
    if args.device == "cuda" and args.jobs != 1:
        raise SystemExit("dryrun: --jobs runs meta passes only")

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCHS)
    n_ok = n_fail = n_skip = 0
    todo = []
    for arch in archs:
        shapes = cells_for(arch)
        if args.shape:
            shapes = [args.shape] if args.shape in shapes else []
        for skip, why in skipped_cells_for(arch).items():
            if args.shape in (None, skip):
                print(f"SKIP {arch} x {skip}: {why}")
                n_skip += 1
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch}__{shape}" + (f"__{mesh_kind}" if mesh_kind
                                            else "")
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    with open(path) as fh:
                        prev = json.load(fh)
                    if prev.get("ok") and (mesh_kind or prev.get(
                            "device") == args.device):
                        print(f"CACHED {tag}")
                        n_ok += 1
                        continue
                todo.append((arch, shape, mesh_kind, path))

    def done(result, path):
        nonlocal n_ok, n_fail
        _report(result, path)
        n_ok, n_fail = n_ok + result["ok"], n_fail + (not result["ok"])

    if args.jobs > 1:
        # train cells first: they take the longest
        todo.sort(key=lambda t: SHAPE_CELLS[t[1]].kind != "train")
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
            futures = {pool.submit(_run_cell_safely, arch, shape,
                                   args.device, mesh_kind): path
                       for arch, shape, mesh_kind, path in todo}
            for fut in as_completed(futures):
                done(fut.result(), futures[fut])
    else:
        for arch, shape, mesh_kind, path in todo:
            print(f"RUN {os.path.basename(path)[:-5]} ...", flush=True)
            done(_run_cell_safely(arch, shape, args.device, mesh_kind),
                 path)
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
