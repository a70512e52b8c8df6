#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device and the CUDA
toolkit (``nvcc``).  The main path is the Mez closed loop at the paper's
camera size (1080x1920): characterize the knob grid with the batched engine
(the hand-written CUDA ``frame_knob_grid`` kernel), then run five cameras
through one fleet subscription (the fused control tick on the card) and
renegotiate one camera's bounds with a live re-sweep.  Phases, one JSON line
each, with their wall seconds:

  build         compile every kernel of ``src/repro_torch/kernels/csrc``
                (one ``nvcc`` per source, all started together) and load
                it; registers and spills per kernel function, failing if a
                redesigned kernel (``NO_SPILL``) spills;
  kernel        every (resolution, colorspace) group at 1080x1920 in three
                cases -- 16 frames without knob4, 16 frames with knob4
                (characterize's shape) and the live re-sweep's own 32-frame
                input with knob4: the kernel against its plain PyTorch
                version on the same inputs (payload within one grey level on
                at most 1e-3 of the bytes, ``changed`` exact, features
                within 1e-3 relative plus what the differing bytes can move,
                and those of the payload produced), each timed three ways:
                device ms behind the spin kernel, traced device ms, and
                ``call_ms`` (CUDA events around one call, host included);
  characterize  ``characterize(engine="batched", include_artifact=True,
                clip_len=8, min_accuracy=0)`` on a 1080x1920 complex camera,
                traced with ``torch.profiler`` for the card's busy share;
  loop          ``MezSystem`` with 5 cameras x 20 frames at 1080x1920, 5
                fps, on the calibrated channel with raw wire sizes, one
                ``fleet=True`` subscription under (100 ms, 0.95) for the
                first half of the streams, retargeted to 30 ms for the rest
                (every lane must move to another setting), then
                ``update_qos(latency=0.060, recharacterize=True)`` on a
                second subscription to cam0 (the live re-sweep);
  profile       device time per activity (per stage) of the group the
                ``kernels`` line names: res 0, BGR, knob4, F=32, and how
                many of its (knob4 block, tile, frame) units the tile
                kernel computes, mirrors or fills (``kernel_work``);
  serve         the model zoo's serving path, ``qwen3-1.7b`` at its
                published widths: the flash and decode attention kernels
                against their plain versions at the serving shapes (float32
                and bfloat16, timed beside the bound, the plain version and
                SDPA; flash in bfloat16 also at D=64, S=1 and S=65, each
                call checked to take the route ``flash_route`` names), the
                whole model in float32 with the kernels against the naive
                attention (prefill and 8 teacher-forced decode steps), the
                timed ``serve(batch=8, prompt_len=1024, gen=256)`` in
                bfloat16 with the kernels' launches counted (every flash
                launch on the ``wgmma`` route), and one traced decode
                step;
  serve_rwkv    the SSM family's serving path, ``rwkv6-1.6b`` at its
                published widths: the wkv scan kernel against its plain
                version (prefill, decode and ragged shapes, float32 and
                bfloat16, timed beside the bound and the plain version),
                the whole model in float32 with the kernel against the
                chunked plain scan (prefill and 8 teacher-forced decode
                steps), the timed ``serve(batch=8, prompt_len=1024,
                gen=256)`` in bfloat16 with the kernel's launches counted
                (one per layer per prefill and per decode step), and one
                traced decode step;
  serve_zoo     the other dense configs and the MoE family at their
                published widths: both attention kernels against their
                plain versions at the zoo's head shapes (QH, KH) = (16,
                16), (32, 8) and (40, 10), D=128 -- flash at B=8 S=1024,
                decode at the serve phase's lengths --, float32 and
                bfloat16, timed as in serve, every bfloat16 flash launch on
                ``wgmma`` (``zoo_kernels``); the float32 model with the
                kernels against naive attention for llama3-8b,
                internlm2-1.8b, phi3-medium-14b and, at 4 of their layers,
                moonshot-v1-16b-a3b and phi3.5-moe-42b-a6.6b (prefill and 8
                teacher-forced decode steps; the MoE's kernel run repeated
                bit for bit, and its routing in both runs compared:
                ``zoo_check``, one line an arch); a timed bfloat16
                ``generate(batch=8, prompt_len=1024, gen=256)`` of
                llama3-8b, phi3-medium-14b, moonshot-v1-16b-a3b at 24 of
                its 48 layers (cut to pay for the later phases) and
                phi3.5-moe-42b-a6.6b at 24 of its 32 layers (83.7 GB of
                weights do not fit the card), after a warm-up, with the
                launches counted and the peak right after ``init_params``
                held to the parameters plus one float32 layer leaf
                (``zoo_serve``, one line an arch); one traced moonshot
                decode step (``zoo_trace``);
  serve_families the VLM and hybrid families at their published widths:
                both attention kernels against their plain versions at
                ``qwen2-vl-72b``'s heads (QH 64 over KH 8, G = 8, D = 128;
                flash at B=8 S=2048) and ``zamba2-7b``'s (32 heads of 112,
                G = 1; flash at B=8 S=1024, and in bfloat16 also S=1 and
                S=65), decode at each serve's lengths, float32 and
                bfloat16, timed as in serve (``fam_kernels``); the float32
                model with the kernels against naive attention, prefill and
                8 teacher-forced decode steps -- qwen2-vl at 4 of its
                layers with 3-stream M-RoPE positions (1024 patches on a 32
                x 32 grid, then 1024 text tokens), zamba2 whole with its
                LoRA redrawn nonzero (``fam_check``, one line an arch); a
                timed bfloat16 ``generate`` after a warm-up -- qwen2-vl at
                16 of its 80 layers (145.4 GB of weights do not fit the
                card; the depth cut to 16 pays for the later phases),
                batch 8, prompt 2048 (1024 patches + 1024 text),
                zamba2 at 42 of its 81 layers (both cut to pay for the
                later phases), batch 8, prompt 1024, gen 256 each -- with
                the launches counted (flash once per attention layer, or
                per shared-block invocation, each prefill; decode the same
                each step) and the peak after ``init_params`` held as in
                ``zoo_serve`` (``fam_serve``, one line an arch); one traced
                zamba2 decode step (``fam_trace``);
  serve_encdec  the audio enc-dec family at its published widths,
                ``seamless-m4t-large-v2`` (24 encoder + 24 decoder layers,
                16 heads of 64): both attention kernels against their
                plain versions at the serve's shapes, float32 and
                bfloat16, timed as in serve -- flash full (not causal)
                over the encoder's B=8 x 1024 frames, full with the
                decoder's 128 tokens over the 1024 frames (cross, Sq !=
                Sk), causal over the 128 tokens; decode over the decoder's
                cache and over the cross cache at length = S_max = 1024
                (``enc_kernels``, every bfloat16 flash launch on
                ``wgmma``); the float32 model at 4 + 4 layers with the
                kernels against naive attention (``enc_check``); the timed
                bfloat16 ``serve(batch=8, prompt_len=1024, gen=256)`` at
                the whole depth, after a warm-up, with 24 + 24 + 24 flash
                launches a prefill and 48 decode launches a step
                (``enc_serve``); one traced decode step (``enc_trace``);
  quant_kernels the approximate collective's quantize and dequantize
                kernels against their plain versions, bit for bit, at every
                gradient leaf shape of the full-width ``qwen3-1.7b`` step
                (float32 and bfloat16, bits 8 and 4), at seven tiles, a
                short tile and a strided layout, on misaligned copies and
                on edge cases (an all-zero tile, .5 ties, +-absmax), each
                launch on the route ``route_for`` names; timed for the
                largest leaf, for each leaf and for the step's 13 + 13
                launches beside the bound, the plain versions and, for
                dequantize, the ``torch.mul`` library call (bitwise the
                plain version);
  train_check   one full-width bfloat16 step's gradients, computed once,
                then the rest of the step twice from the same parameters
                and optimizer state -- the round trip through the kernels
                and through the plain versions: the compressed gradients
                and every new parameter must be bitwise identical;
  train         ``train("qwen3-1.7b", reduced=False, steps=4, batch=8,
                seq=4096, grad_bits=8, checkpoint_every=2,
                inject_failure_at=3)``: step times, tokens/s, peak memory,
                the losses (finite), the recovery from step 2's checkpoint
                and the kernels' launches (13 + 13 per executed step, all
                on the contiguous route, as in train_check and
                collective);
  train_trace   one traced full-width training step: the card's busy
                share, the top activities and the two kernels' share;
  collective    ``compressed_mean`` on a one-rank NCCL group over the
                largest gradient leaf (bitwise the plain round trip at
                bits 8 and 4, the exact mean at 16), and the
                ``CollectiveController`` over a 60-step contention sequence
                with decisions identical to the host ``LatencyController``;
  train_families every model family trained at its published widths
                through ``build_train_step`` with ``grad_bits=8`` and
                attention ``"chunked"`` (``TF_FAMILIES``): seamless and
                rwkv6 whole, moonshot at 4 layers, phi3.5-moe at 2,
                qwen2-vl at 2 (batch 1, its 1024 patches + 1024 text),
                zamba2 at 12 (two shared-block invocations).  Each: step
                0's gradients through the kernels' 8-bit round trip bit
                for bit against the plain one, then 3 AdamW steps on one
                repeated batch with the quantize kernels' launches counted
                (every launch contiguous) and the loss falling; step p50
                and peak memory (one line a family);
  remat         ``remat="dots"`` against ``"full"`` and ``"none"``:
                ``qwen3-1.7b`` at its published widths, bf16, attention
                ``"chunked"``, one microbatch of 2 x 2048 through
                ``compute_grads`` under each policy -- a traced first call
                (the card's busy share), then seconds and the peak over the
                baseline beside the meta reckoning and the predicted
                ``"dots"`` minus ``"full"``, the peaks ordered full < dots
                < none, the
                gradients under ``"dots"`` and ``"none"`` within 2^-10 of
                each leaf's norm of those under ``"full"`` (bitwise leaves
                counted) --; then two ``build_train_step`` steps under
                ``"dots"`` with the 8-bit hook (step 0's round trips bitwise
                the plain ones, every launch contiguous, the loss falling)
                and ``examples/torch_train_100m.py``'s ``main`` at its
                defaults (30 steps of 8 x 256 on the card, the loss
                falling);
  dryrun        the dry-run (``launch/dryrun.py``): every runnable (arch
                x shape) cell of ``SHAPE_CELLS`` accounted on the meta
                device in a subprocess (32 ok, 0 failed, 8 skipped; one
                ``dryrun_meta`` line a cell: bytes, FLOPs, bytes accessed,
                transcendentals, fits, cut)
                while five cells cut to the card are served on it
                (``DRYRUN_CELLS``: qwen3 ``prefill_32k`` at batch 2 and
                ``decode_32k`` at batch 8, rwkv6 ``prefill_32k`` at batch
                4 and ``long_500k``, zamba2 ``long_500k`` at 36 layers):
                each kernel at the cell's shape against its plain version
                and timed beside its bound and SDPA, the step through the
                kernels with its launches counted against the same step
                through the plain routes, and each run's measured bytes
                beside the meta pass's reckoning (one ``dryrun_cut`` line
                a cell, then a ``dryrun`` line);
  frame_knobs_kernel  the camera node's knob kernel against its plain
                version, bit for bit, at 1080x1920 (N=25, uint8 and float32,
                blur 1/5/8/10/15, identical frames, N=1, and the camera
                path's overlapping float32 window ``g[1:]``/``g[:-1]`` of
                26 planes at blur 5), each call on the route
                ``knobs_route`` names, each case timed behind the spin
                kernel beside the plain version and the bound;
  camera_node   the camera node's device path at the testbed's size: five
                1080p complex cameras append 200 frames each into device
                rings of 150 BGR frames (4.67 GB), half from the host and
                half from the card, plus one refused out-of-order append
                each; point and range queries bit-equal to the frames
                appended; each camera's 26-frame window through
                ``ops.frame_knobs`` as gray planes (5 launches), held to
                the plain version; append, query and kernel times, peak
                memory;
  scenario      the scripted-experiment path (``core/scenario.py``,
                ``core/federation.py``, ``core/mqtt_bridge.py``) at the
                harness's own size, 144x256 frames at 5 fps: characterize
                the complex table (clip 12, floor 0.95) through the kernel
                (launches counted; kept settings, accuracies and best
                settings equal to the CPU's, sizes within ``SIZE_RTOL``);
                the paper claim (5 cameras, a 10x interference spike) on
                the fleet tick twice (identical traces; each tick timed,
                host clock ending in a synchronise, and one run traced for
                the card's busy share and each tick's split into launches,
                copies, synchronises and other host work) and
                uncontrolled, held to tests/test_scenario.py's bounds; the
                three golden traces of tests/golden byte for byte (the
                sceneshift run re-sweeping through the kernel); a 1-broker
                herd against ``MezSystem`` and the gauntlet's 2-broker
                federated run (exactly once, ledger conserved); QoS 0 and 1
                through ``MqttBridge`` over a 35%-loss hop.  Then every
                ``frame_knob_grid`` launch of the phase, at its own inputs,
                bitwise against the plain version on the CPU (the card's
                plain version is no oracle at 144x256), timed together.
  mesh          the fleet mesh and the sharded training step:
                tests/test_fleet_sharded.py's 13 cameras through its
                36-tick swap and retarget sequence on an 8-way lane split
                of the one card (padded to 16 lanes), on
                ``fleet_mesh(1)`` and with ``mesh=None`` (the
                one-device mesh of the fleet's device), every decision
                identical to a host ``LatencyController``'s, one table layout each, each
                tick's p50 on the host clock (the split on one card only
                adds launches: a cost, not a gain); that test's scenario
                meshed, unmeshed and on the host, byte-equal; then
                ``train("qwen3-1.7b", reduced=True, mesh_shape=(1, 1),
                grad_bits=8, steps=3)`` on a one-rank NCCL group, its
                losses and final parameters bitwise the meshless run's
                (both under ``torch.use_deterministic_algorithms``), the
                quantize pair's launches counted from zero (one each a
                leaf of at least 1024 elements: 8 + 8 a step at the
                reduced widths, all contiguous), the step p50 of both
                runs;
  tp            tensor-parallel compute: the decode kernel's log-sum-exp
                row by row against the plain version's at the serve
                phase's decode shapes (its output the same bits as
                without it; a planted fault, the log-sum-exps shifted by
                one row, read above the limit; both launches timed in
                bfloat16); ``qwen3-1.7b`` at its published widths in
                bfloat16, prefill B=8 S=1024 and 8 decode steps, through
                the partitioned steps on a one-rank NCCL (1, 1) mesh
                against the meshless steps: 28 flash launches a prefill
                and 28 decode launches with the log-sum-exp a step
                counted, logits and written cache rows within 2^-4
                relative (and whether bitwise); the (1, 1) steps' measured
                bytes against the dry-run's ``--mesh`` meta reckoning of
                the same steps on a fake (1, 1) group (the plain routes
                within 1%); ``rwkv6-1.6b``, ``seamless-m4t-large-v2``
                and ``zamba2-7b`` (24 of 81 layers) the same way (every
                logit and cache tensor within 2^-4 and whether bitwise;
                the wkv, flash and decode-with-lse launches counted from
                zero); the flash (full and causal), decode (with the
                log-sum-exp) and wkv kernels at one (16, 16) rank's
                shapes of the dry-run cells against their plain
                versions, with planted faults, timed beside the bound and
                SDPA; then the model axis at 2 tried in two
                processes over gloo with the card's tensors (whether gloo
                carried every collective, and their logits against the
                meshless serve's).

Then a ``kernels`` line (every kernel: launches on its main path, error
against its plain version, its time beside its bound, the plain version's
and the library call's; the attention pair also its ``kernel_route`` and
``call_ms``, the wrapper's time with its host work, its launches on every
serving path, and its rows at the zoo's and the families' head shapes and
at the enc-dec serve's full, cross and cross-decode shapes, and with
the wkv scan at the dry-run's 32k and 500k shapes; the quantize
pair its launches on every training path, the remat phase's ``"dots"``
steps and the mesh phase's (1, 1) run among them),
the card's ``name,
power.limit``, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line; without a CUDA device, or outside a checkout, it exits 2.

    python3 chip_smoke.py --grid-only [--src OTHER_CHECKOUT/src]

runs only the build, kernel and profile phases of ``frame_knob_grid``,
against this checkout's port or another's: two checkouts timed in one run
on one card (A/B) by the same phases.

    python3 chip_smoke.py --quant-only [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --wkv-only [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --knobs-only [--src OTHER_CHECKOUT/src]

do the same for the quantize pair (the build and quant_kernels phases),
the wkv scan (the build and rwkv_kernels phases) and the camera node's
knob kernel (the build and frame_knobs_kernel phases).

    python3 chip_smoke.py --scenario-only
    python3 chip_smoke.py --zoo-only
    python3 chip_smoke.py --families-only
    python3 chip_smoke.py --encdec-only
    python3 chip_smoke.py --train-families-only
    python3 chip_smoke.py --dryrun-only
    python3 chip_smoke.py --remat-only
    python3 chip_smoke.py --mesh-only
    python3 chip_smoke.py --tp-only

build ``frame_knob_grid`` and run only the scenario phase, or build the
two attention kernels and run only the serve_zoo, the serve_families or
the serve_encdec phase, or build the quantize pair and run only the
train_families phase, or build the attention and wkv kernels and run
only the dryrun phase, or build the quantize pair and run only the remat
or the mesh phase, or build the attention and wkv kernels and run only
the tp phase.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H, W = 1080, 1920           # the paper's camera (repro_torch.core.knobs)
FRAME_BUCKET = 16           # the grid engine pads its frame axis to these
CLIP_LEN = 8                # calibration clip (the paper's campaign: 24)
# The table keeps every measured setting.  At 1080x1920 the smallest
# setting above the default 0.90 floor already has the table's best
# accuracy, so a 0.90 table offers the controller one setting at every size.
TABLE_FLOOR = 0.0
RETARGET_LATENCY = 0.030    # mid-stream bound that setting cannot meet
N_CAMS, N_FRAMES = 5, 20    # the paper's testbed: 5 camera nodes
REPS = 5                    # timed calls per group, after one warm-up
PLAIN_REPS = 2              # of a grid group's plain version (~0.15 s each)
ATTN_REPS = 10              # calls per device timing of attention
SPIN_CYCLES = 20_000_000    # ~10 ms of spin at the H100's clocks, the first
SPIN_MAX_CYCLES = 800_000_000   # try; x4 while the host outlasts it, to ~0.4 s
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor cores
PAYLOAD_TOL, MISMATCH_TOL, FEAT_RTOL = 1, 1e-3, 1e-3

# -- the serve phase ------------------------------------------------------------
SERVE_ARCH = "qwen3-1.7b"
SERVE_REDUCED = False       # the published widths (a CPU rehearsal: True)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 1024, 256
# kernel checks at the serving shapes: flash (B, S) causal, QH/KH/D of the
# config; decode over the serve's cache (S_max = 1024 + 256 + 256) at these
# lengths (1152: the mean length of the serve's decode steps)
FLASH_SHAPES = ((8, 1024), (8, 1000))
# bfloat16 only, beside them: (B, S, D) -- the tensor-core route at D=64,
# one query row, and one row past a 64-key tile
FLASH_EXTRA = ((8, 1024, 64), (8, 1, 128), (8, 65, 128))
# kernel functions of the redesigned kernels, which must build without spills
NO_SPILL = ("flash_wgmma", "decode_fused", "fkg_prologue", "fkg_tile",
            "fkg_final", "quantize_cluster", "dequantize_stream",
            "wkv_chunk_scan", "knobs_tile")
DECODE_S_MAX = 1536
DECODE_LENGTHS = (1, 1024, 1152, 1279, 1536)
# max |kernel - plain| on unit-normal inputs, per (kernel, dtype).  bf16:
# one rounding of the f32 result apart, at the largest |o| each kernel
# gives -- flash's early causal rows average a few values (|o| up to ~4,
# where one bf16 step is 1.6e-2-3.1e-2 rounds to 2e-2); decode over >= 1024
# rows keeps |o| below ~0.5 (one step <= 2e-3), and at length 1 both are
# exact.  f32: summation order only.
ATTN_TOL = {("flash_attention", "float32"): 2e-5,
            ("flash_attention", "bfloat16"): 2e-2,
            ("decode_attention", "float32"): 2e-5,
            ("decode_attention", "bfloat16"): 2e-3}
# the whole model in float32, kernels against naive attention
CHECK_BATCH, CHECK_PROMPT, CHECK_STEPS = 4, 1000, 8
LOGIT_RTOL = 1e-3           # of max |logit|, at each step

# -- the serve_rwkv phase -------------------------------------------------------
RWKV_ARCH = "rwkv6-1.6b"
RWKV_REDUCED = False        # the published widths (a CPU rehearsal: True)
RWKV_BATCH, RWKV_PROMPT, RWKV_GEN = 8, 1024, 256
# kernel checks, (B, S, random state0): the serve's prefill from a zero and
# from a random state, a decode step, a length no chunk of 64 divides, and
# one token of one sequence; H and K of the config
WKV_SHAPES = ((8, 1024, False), (8, 1024, True), (8, 1, True),
              (8, 1000, True), (1, 1, True))
# the kernel against wkv_plain, as a share of the plain result's max |.|.
# float32: the kernel multiplies expf(logw) step by step where the plain
# version takes exp of differences of cumulative sums over its chunk, so
# the two round apart by a few float32 ulps per step over <= 1024 steps;
# bfloat16 y: one rounding of the float32 result apart, one bf16 step
# (2^-7 of |y|); the state stays float32 in both.
WKV_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7, "state": 1e-4}
WKV_PLAIN_CHUNK = 64        # [B, 64, 64, H, K] f32: ~270 MB at B=8
# the whole model in float32, the kernel against the chunked plain scan
# (chunk min(512, 256) = 256: ~2 GB temporaries)
RWKV_CHECK_BATCH, RWKV_CHECK_PROMPT = 4, 256

# -- the serve_zoo phase --------------------------------------------------------
# The dense and MoE configs beside qwen3, at their published widths.  The
# attention kernels at their head shapes, (arch, QH, KH): G = 1, 4 and 4
# with QH 40; flash at B=8 S=1024, decode over the serve's cache at
# DECODE_LENGTHS.
ZOO_REDUCED = False         # the published widths (a CPU rehearsal: True)
ZOO_HEADS = ("moonshot-v1-16b-a3b", "llama3-8b", "phi3-medium-14b")
ZOO_FLASH = ((8, 1024),)
# the float32 model, kernels against naive attention: (arch, layers).  The
# MoE pair runs 4 of its layers in float32 (moonshot whole would be 116 GB;
# 4 layers ~12 GB, phi3.5-moe ~22 GB), at the published widths.
ZOO_CHECK = (("llama3-8b", None), ("internlm2-1.8b", None),
             ("phi3-medium-14b", None), ("moonshot-v1-16b-a3b", 4),
             ("phi3.5-moe-42b-a6.6b", 4))
# the timed bfloat16 serves: (arch, layers).  phi3.5-moe's 32 layers are
# 83.7 GB of weights; at 24 layers 62.9 GB (and 1.2 GB of cache) fit.
# moonshot's 48 layers run at 24 since the dryrun phase came (its whole
# serve took ~32 s of the smoke's time limit).
ZOO_SERVE = (("llama3-8b", None), ("phi3-medium-14b", None),
             ("moonshot-v1-16b-a3b", 24), ("phi3.5-moe-42b-a6.6b", 24))
ZOO_BATCH, ZOO_PROMPT, ZOO_GEN = 8, 1024, 256
ZOO_TRACE = "moonshot-v1-16b-a3b"

# -- the serve_families phase ---------------------------------------------------
# The VLM and hybrid families at their published widths (configs built as
# zoo_config builds them, reduced under ZOO_REDUCED).  qwen2-vl-72b: QH 64
# over KH 8 (G = 8) at D = 128, its prompt 1024 stub patch embeddings + 1024
# text tokens; zamba2-7b: 32 heads of 112 (G = 1), a 1024-token prompt.
# (arch, layers, prompt): qwen2-vl's 80 layers are 145.4 GB of bf16
# weights; 32 layers (61.2 GB) fit the card, and 16 (33.1 GB, and 1.4 GB of
# cache at B=8) run here, cut to pay for the later enc-dec and training
# phases within the time limit; zamba2's 81 layers at 42 (7 shared-block
# invocations; its whole serve took ~23 s) since the dryrun phase came.
FAM_SERVE = (("qwen2-vl-72b", 16, 2048), ("zamba2-7b", 42, 1024))
FAM_BATCH, FAM_GEN = 8, 256
# bfloat16 flash at zamba2's heads beside the serving shape: one query row
# and one row past a 64-key tile (the D = 112 tile's ragged tails)
FAM_FLASH_EXTRA = ((8, 1, 112), (8, 65, 112))
# the float32 model, kernels against naive attention: (arch, layers,
# prompt).  qwen2-vl at 4 layers (~24 GB) with 3-stream M-RoPE positions
# (FAM_GRID x FAM_GRID patches), zamba2 whole (27 GB); zamba2's prompt is a
# multiple of the SSD chunk (128), as the JAX function asserts.
FAM_CHECK = (("qwen2-vl-72b", 4, 2048), ("zamba2-7b", None, 1024))
FAM_GRID = 32
FAM_TRACE = "zamba2-7b"

# -- the serve_encdec phase ---------------------------------------------------
# The audio enc-dec family at its published widths: seamless-m4t-large-v2,
# 24 encoder + 24 decoder layers, 16 heads of 64 (G = 1).  A serve prompt of
# ENC_PROMPT stub audio frames and ENC_PROMPT // 8 decoder tokens
# (registry.make_batch), then ENC_GEN decode steps; its decoder cache holds
# ENC_PROMPT + ENC_GEN + DECODE_SLACK rows, its cross cache ENC_PROMPT.
ENC_ARCH = "seamless-m4t-large-v2"
ENC_BATCH, ENC_PROMPT, ENC_GEN = 8, 1024, 256
ENC_CHECK_LAYERS = 4        # the float32 check: 4 encoder + 4 decoder layers

# -- the train_families phase -------------------------------------------------
# Every model family trained at its published widths through the training
# step (launch.steps.build_train_step, as launch/train.py builds it) with
# grad_bits=8 and attention "chunked": (arch, layers or None for the whole
# depth, batch, seq).  Depth cuts fit one card: bf16 parameters and
# gradients plus float32 AdamW moments are ~12 bytes a parameter, and the
# config's microbatches add float32 gradient sums (4 more).  qwen2-vl's
# batch is cut to 1 (one microbatch: no float32 sums) and its sequence is
# its 1024 stub patches + 1024 text tokens.
TF_FAMILIES = (("seamless-m4t-large-v2", None, 8, 512),
               ("rwkv6-1.6b", None, 8, 512),
               ("moonshot-v1-16b-a3b", 4, 8, 512),
               ("phi3.5-moe-42b-a6.6b", 2, 8, 512),
               ("qwen2-vl-72b", 2, 1, 2048),
               ("zamba2-7b", 12, 8, 512))
TF_STEPS = 3

# -- the remat phase ----------------------------------------------------------
# remat="dots" against "full" and "none": qwen3-1.7b at its published
# widths, bf16, its training attention ("chunked"), one microbatch of
# REMAT_BATCH x REMAT_SEQ through compute_grads under each policy ("none"
# first: its float32 chunk scores, reckoned at 75.9 GB on meta, need the
# emptiest card); then REMAT_STEPS steps of build_train_step under "dots"
# with the 8-bit hook (phase_train_family); then the 100M example's main.
REMAT_ARCH = "qwen3-1.7b"     # reduced under ZOO_REDUCED (a CPU rehearsal)
REMAT_BATCH, REMAT_SEQ = 2, 2048
REMAT_POLICIES = ("none", "full", "dots")
REMAT_STEPS = 2             # a step, and a second to see the loss fall
REMAT_GRAD_RTOL = 2.0 ** -10    # ||g - g_full|| / ||g_full||, leaf by leaf
# "dots" minus "full", predicted before the first card run: the products
# JAX saves (q 2048, k 1024, v 1024, wo 2048, gate 6144, up 6144 bf16 a
# token a layer) and the port's one more (the down projection, 2048)
REMAT_PREDICTED_GB = {"jax_products": 28 * 4096 * 18432 * 2 / 1e9,
                      "port_products": 28 * 4096 * 20480 * 2 / 1e9}
EXAMPLE_100M = ROOT / "examples" / "torch_train_100m.py"

# -- the dryrun phase ---------------------------------------------------------
# The dry-run (launch/dryrun.py).  (a) Every runnable (arch x shape) cell of
# the JAX package's SHAPE_CELLS accounted on the meta device, in a
# subprocess of DRYRUN_JOBS workers (the card's host has 8 cores: 7 workers
# and this process; at 5 the meta pass, ~83 s, outlasted the cuts' ~57 s)
# while (b) five cells, cut to one card, are served on it through the
# kernels:
# (arch, shape, batch or None for the cell's, layers or None for all).
# qwen3's prefill at 2 of 32 sequences (7.6 GB of cache) and decode at 8 of
# 128 (30.3 GB), rwkv6's prefill at 4 of 32 (at 8 its time-mix's float32
# [B, S, 5, D] mixes, 10.7 GB each, took the card past 75 GB), both rwkv6
# long_500k and zamba2's at 36 of 81 layers (6 shared-attention
# invocations: 45.1 GB of its 97.9 GB cache).
DRYRUN_CELLS = (("qwen3-1.7b", "prefill_32k", 2, None),
                ("qwen3-1.7b", "decode_32k", 8, None),
                ("rwkv6-1.6b", "prefill_32k", 4, None),
                ("rwkv6-1.6b", "long_500k", None, None),
                ("zamba2-7b", "long_500k", None, 36))
DRYRUN_JOBS = 7
DRYRUN_META_ARCH = None     # None: every arch (a CPU rehearsal: one)
DRYRUN_META_TIMEOUT_S = 600
DRYRUN_REDUCED = False      # the published widths (a CPU rehearsal: True)
DRYRUN_SEQ = {}             # shape -> sequence (a CPU rehearsal: short)
# a prefill's plain step runs on its first rows: the chunked attention's
# float32 scores at S = 32768 are ~0.4 s of card time a layer a row
DRYRUN_PLAIN_ROWS = 1
# the kernel step against the plain step: launch.dryrun.STEP_RTOL.  The
# cuts whose step a fault planted in every launch (every layer's attention
# or scan) must move past it: 77-111% on the H100 against 1.3-4.4% sound
DRYRUN_STEP_FAULTS = (("qwen3-1.7b", "decode_32k"),
                      ("rwkv6-1.6b", "prefill_32k"),
                      ("rwkv6-1.6b", "long_500k"))
# the kernels at the cut cells' shapes, on seeded unit-normal inputs and at
# each launch of a cut step: the largest over rows (a query head's D values;
# a wkv row's K values, y in bf16 and the state in float32) of ||kernel -
# plain|| / ||plain||.  An absolute limit sees nothing at long context:
# decode over 524288 unit-normal keys gives |o| ~ 2e-3.  Sound, the two
# round apart by about a bf16 step (2^-8) in some of a row's values;
# skipping m of n near-uniform keys moves a row by about sqrt(m e / n):
# 3.6% for the last 256 of 524288 rows, 35% for the last split of 8.
DRYRUN_ROW_RTOL = {"bfloat16": 2.0 ** -6, "state": 1e-4}
DRYRUN_TAIL_ROWS = 256      # a flash launch in a step: its last query rows
DRYRUN_SCAN_HEADS = 4       # a wkv launch in a step: every 4th head,
DRYRUN_SCAN_CHUNK = 256     # the plain scan at this chunk (a launch each)

# -- the training phases ------------------------------------------------------
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_REDUCED = False       # the published widths (a CPU rehearsal: True)
# the JAX package's train_4k cell (configs/base.py: seq 4096, global batch
# 256), its batch cut to 8 for one card; 4 microbatches of 2 (the config's)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_BITS = 8, 4096, 4, 8
# a checkpoint after step 2, a failure at step 3 and the replay from step 2:
# 5 steps run (10 steps, a checkpoint every 4 and a failure at 6 -- 12 steps
# run, 171 s -- until the remat phase came)
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 2, 3
CHECK_SEQ = 1024            # train_check: the leaves' shapes at any length
GRAD_MIN_SIZE = 1024        # launch/train.py's make_grad_compressor(min_size)
QUANT_BLOCK = (256, 512)
# beside the leaves: seven tiles (no multiple of a cluster's or the grid's
# share), a short tile (M < 256) and a strided layout (N > bn)
QUANT_EXTRA_SHAPES = ((256 * 7, 512), (128, 512), (1024, 1536))
COLLECTIVE_STEPS = 60       # tests/test_runtime.py's contention sequence

# -- the camera node ----------------------------------------------------------
# configs/mez_edge.py's testbed at the paper's camera size: N_CAMS cameras,
# each with a device ring of 150 BGR uint8 frames (30 s at 5 fps; 5 x 150 x
# 6.22 MB = 4.67 GB on the card), 200 appends a camera (the ring wraps), a
# 26-frame subscriber window read out of each ring, and its 25 consecutive
# gray pairs through frame_knobs with the path's blur width
# (benchmarks/compute.py's blur_k=5)
CAM_CAPACITY, CAM_DISTINCT, CAM_APPENDS, CAM_WINDOW = 150, 30, 200, 26
KNOBS_N, KNOBS_BLUR = CAM_WINDOW - 1, 5
KNOBS_BLURS = (1, 5, 8, 10, 15)     # no blur, and knobs.BLUR_KERNELS' widths
QUERY_REPS = 50                     # point queries timed on one ring

# -- the scenario harness -----------------------------------------------------
# The harness's own size: CameraSpec carries no resolution, so its cameras
# are CameraConfig's 144x256 frames at 5 fps (configs/mez_edge.py, what the
# goldens pin); fleets are the paper's 5-camera testbed (the claim) and the
# gauntlet's 2-broker herd of 4 cameras.
GOLDEN_DIR = ROOT / "tests" / "golden"
SCEN_CLAIM_CLIP = 12        # tests/test_scenario.py's complex_table
FED_FRAMES = 60             # benchmarks/gauntlet.py's federated, quick
MQTT_FRAMES = 30            # frames a camera through the bridge
FKG_NAMES = ("fkg_prologue", "fkg_prologue_x4", "fkg_tile", "fkg_final")
# the card's characterize against the CPU's: each setting's mean wire size
# (from the kernel's proxy features) within this relative distance; the
# features' log2 sums are summed in another order there (7.4e-8 measured
# on the complex table)
SIZE_RTOL = 1e-5
TICK_LABEL = "chip_smoke.fleet_tick"    # profiler range around each tick
# the mesh phase: tests/test_fleet_sharded.py's 13 cameras on an 8-way
# lane split (padded to 16 lanes) through its swap (step 10) and retarget
# (step 22) sequence, and a one-rank (1, 1) training mesh
MESH_CAMS, MESH_SPLIT, MESH_STEPS = 13, 8, 36
MESH_TRAIN = dict(steps=3, batch=8, seq=128, grad_bits=8, seed=0)
# the tp phase: qwen3-1.7b's serve (prefill B=8 S=1024, then decode steps)
# through the partitioned steps on a one-rank (1, 1) NCCL mesh against the
# meshless steps, and the model axis at 2 in two processes over gloo
TP_ARCH = "qwen3-1.7b"
TP_BATCH, TP_PROMPT, TP_STEPS, TP_TWO_STEPS = 8, 1024, 8, 3
# the two-process run's training step under the sequence_parallel hint
# and without it: batch x sequence
TP_TRAIN_BATCH, TP_TRAIN_SEQ = 2, 2048
# the other families' partitioned serve on the (1, 1) mesh, at the same
# batch, prompt and steps: (arch, layers or None for all); zamba2 at 24 of
# its 81 layers (4 shared-block invocations; 6.1 GB of weights)
TP_FAMILIES = (("rwkv6-1.6b", None), ("seamless-m4t-large-v2", None),
               ("zamba2-7b", 24))
# the kernels at one rank's shapes on the production mesh's model axis:
# the dry-run cells' blocks of a (16, 16) rank -- (kernel's arch, cell,
# full attention) -- the batch over 16 DP ranks, a prefill's heads over
# the model axis, a decode step over every head and the last rank's row
# block of the cache (its rows - DECODE_SLACK valid)
TP_RANK_M = 16
TP_RANK_CELLS = (("rwkv6-1.6b", "prefill_32k", False),
                 ("rwkv6-1.6b", "decode_32k", False),
                 ("seamless-m4t-large-v2", "prefill_32k", True),
                 ("zamba2-7b", "prefill_32k", False),
                 ("seamless-m4t-large-v2", "decode_32k", False),
                 ("zamba2-7b", "decode_32k", False))
TP_BYTES_RTOL = 0.01        # measured step bytes against the reckoning
TP_TWO_TIMEOUT_S = 300
LSE_RTOL = 1e-5             # |lse - plain| / max(1, |plain|), row by row


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median over ``reps`` calls of ``fn`` timed with CUDA events (after
    one untimed warm-up call)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(fn, reps: int) -> tuple[float, bool]:
    """Device time of one call of ``fn``: ``reps`` calls enqueued behind a
    spin kernel (``torch.cuda._sleep``) that keeps the card busy while the
    host enqueues them, timed with CUDA events around the calls, median of
    3 such runs (after one untimed warm-up call).  The wrapper's host time,
    which dominates a CUDA-event timing of one call whose device work is
    short, is hidden as long as the enqueueing ends before the spin does: a
    run whose host outlasted the spin is made again behind a spin four
    times longer, up to ``SPIN_MAX_CYCLES``; returns (ms per call, whether
    the spin hid the host in every kept run)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times, hidden, spin = [], True, SPIN_CYCLES
    for _ in range(3):
        while True:
            spin0, start, stop = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(3))
            spin0.record()
            torch.cuda._sleep(spin)
            start.record()
            t0 = time.monotonic()
            for _ in range(reps):
                fn()
            host_ms = (time.monotonic() - t0) * 1e3
            stop.record()
            stop.synchronize()
            ok = host_ms < spin0.elapsed_time(start)
            if ok or spin >= SPIN_MAX_CYCLES:
                break
            spin *= 4
        hidden = hidden and ok
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times), hidden


def bound_ms(plan, n_frames: int, with_art: bool) -> tuple[float, str]:
    """Least time of one grid call on the card: inputs read once and
    outputs written once over the memory rate, against the f32 band
    arithmetic (2 FLOP per tap of the separable passes) over the f32
    rate."""
    hw3 = plan.in_h * plan.in_w * 3
    s, p = plan.n_settings, plan.n_planes
    n_out = s * n_frames * p * plan.out_h * plan.out_w
    bands = sum(b.start.nbytes + b.length.nbytes + b.weight.nbytes
                for b in (plan.ry_band, plan.rx_band, plan.by_band,
                          plan.bx_band))
    nbytes = (2 * n_frames * hw3 + (hw3 + 4 * n_frames if with_art else 0)
              + bands + n_out + s * n_frames * 7 * 4)
    n_blocks = len(set(plan.art_ids.tolist()))
    # separable passes: vertical over every input column, then horizontal
    resize = (int(plan.ry_band.length.sum()) * plan.in_w
              + int(plan.rx_band.length.sum()) * plan.out_h)
    blur = int((plan.by_band.length.sum(-1) * plan.out_w
                + plan.bx_band.length.sum(-1) * plan.out_h).sum())
    flops = 2.0 * n_frames * p * (n_blocks * resize + blur)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want) -> tuple[int, float]:
    """The kernel contract; returns (max |payload delta|, mismatch
    fraction) or raises."""
    import torch
    from repro_torch.kernels import frame_knobs as FK
    pg, fg, cg = got
    pw, fw, cw = want
    if pg.shape != pw.shape or not torch.equal(cg, cw):
        raise AssertionError("payload shape or changed fraction differs "
                             "from plain")
    # one setting at a time: a 1080p group's payload is up to 3 GB
    max_d, n_diff = 0, 0
    for s in range(pg.shape[0]):
        d = (pg[s].to(torch.int16) - pw[s].to(torch.int16)).abs()
        max_d = max(max_d, int(d.max()))
        n_off = (d != 0).sum((-3, -2, -1))[..., None].float()
        n_diff += int(n_off.sum())
        # against plain's features: each payload byte off by one moves
        # each feature by at most 2 (it enters two deltas per direction)
        if ((fg[s] - fw[s]).abs() > FEAT_RTOL * fw[s].abs()
                + 2.0 * n_off).any():
            raise AssertionError("proxy features differ from plain's")
        own = FK.proxy_features(pg[s])
        if not torch.equal(fg[s][..., [1, 2, 4, 5]],
                           own[..., [1, 2, 4, 5]]):
            raise AssertionError("proxy feature counts differ from the "
                                 "payload's")
        rel = ((fg[s][..., [0, 3]] - own[..., [0, 3]]).abs()
               / own[..., [0, 3]].abs().clamp(min=1.0)).max()
        if float(rel) > FEAT_RTOL:
            raise AssertionError(f"proxy log2 sums off by {float(rel)} "
                                 f"relative")
        del d, own
    frac = n_diff / pg.numel()
    if max_d > PAYLOAD_TOL or frac > MISMATCH_TOL:
        raise AssertionError(f"payload max |d| {max_d}, mismatch {frac}")
    return max_d, frac


def grid_inputs(dev, background, frames):
    """A clip laid out as ``grid_engine.run_grid`` lays it out: the
    background first, the clip, then the background again up to a whole
    frame bucket; knob4 enabled on the clip's own frames only.  Returns
    (frames, prev, background, art_enable) on ``dev``."""
    import numpy as np
    import torch
    n_real = len(frames) + 1
    n_pad = -(-n_real // FRAME_BUCKET) * FRAME_BUCKET
    stack = np.stack([background] + list(frames)
                     + [background] * (n_pad - n_real))
    fj = torch.as_tensor(stack).to(dev)
    enable = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    enable[1:n_real] = 1
    return fj, torch.cat([fj[:1], fj[:-1]]), fj[0], enable


def traced_ms(fn, reps: int) -> tuple[float, dict]:
    """Device time of one call of ``fn`` from a ``torch.profiler`` trace of
    ``reps`` calls (after one untimed warm-up call): the summed durations
    of the card's activities (kernels, copies, memsets) per call, and per
    activity name its recorded count and ms per call.  Unlike
    ``device_ms`` it needs no spin to hide the host, so it also times a
    wrapper that synchronises inside a call; the trace may drop
    activities on this machine, so both are lower bounds, and each
    activity also gives its ms per recorded launch (each grid call
    launches each of its kernels once)."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            t = per.setdefault(e.name(), [0, 0.0])
            t[0] += 1
            t[1] += (e.end_ns() - e.start_ns()) / 1e6
    stages = {k: {"recorded": c, "ms_per_call": ms / reps,
                  "ms_per_launch": ms / c}
              for k, (c, ms) in sorted(per.items(), key=lambda kv: -kv[1][1])}
    return sum(ms for _, ms in per.values()) / reps, stages


def phase_kernel(dev, *, need_hidden: bool = True):
    """Every group in three cases, kernel against plain, and the times of
    both beside the bound.  ``check``: 15 frames of the complex camera,
    no knob4 (F=16).  ``characterize``: the same frames with knob4 (F=16,
    15 settings), the shape of ``characterize(include_artifact=True)``.
    ``resweep``: the live re-sweep's own inputs -- cam0's background and
    its 16-frame log tail, padded to F=32, with knob4 (the live table keeps
    knob4 settings).  Each group's kernel is timed three ways: ``ms``, the
    device time behind the spin kernel (``device_ms``; raises unless the
    spin hid the host, when ``need_hidden``); ``traced_ms``, its traced
    device activities (``traced_ms``); and ``call_ms``, CUDA events around
    one whole call, host work included (``cuda_ms``).  Returns (rows,
    worst error)."""
    import torch
    from repro_torch.configs.mez_edge import CONFIG
    from repro_torch.core import knobs as K
    from repro_torch.core.broker import RECHAR_CLIP_LEN
    from repro_torch.data.camera import CameraConfig, SyntheticCamera
    from repro_torch.kernels import frame_knobs as FK
    # the calibration camera is also the loop's cam0 (same id and seed)
    cam = SyntheticCamera(CameraConfig(height=H, width=W, dynamics="complex",
                                       seed=CONFIG.seed))
    stream = [cam.next_frame()[1] for _ in range(N_FRAMES)]
    clip = grid_inputs(dev, cam.background, stream[:FRAME_BUCKET - 1])
    tail = grid_inputs(dev, cam.background, stream[-RECHAR_CLIP_LEN:])
    cases = (("check", (0,), clip), ("characterize", (0, 1, 2), clip),
             ("resweep", (0, 1, 2), tail))
    rows, worst = [], (0, 0.0)
    for case, art, (frames, prev, bg, enable) in cases:
        kw = {} if art == (0,) else dict(background=bg, art_enable=enable)
        n = frames.shape[0]
        for res in range(len(K.RESOLUTION_SCALES)):
            for cs in range(len(K.COLORSPACES)):
                plan = FK.build_transform_plan(
                    H, W, scale=K.RESOLUTION_SCALES[res], cs=cs,
                    blur_ks=K.BLUR_KERNELS, art_modes=art)
                got = FK.frame_knob_grid(frames, prev, plan, device=dev,
                                         **kw)
                want = FK.frame_knob_grid_plain(frames, prev, plan, **kw)
                torch.cuda.synchronize()
                max_d, frac = compare(got, want)
                del got, want
                torch.cuda.empty_cache()
                worst = (max(worst[0], max_d), max(worst[1], frac))

                def call():
                    return FK.frame_knob_grid(frames, prev, plan,
                                              device=dev, **kw)

                ms, hidden = device_ms(call, REPS)
                if need_hidden and not hidden:
                    raise AssertionError(f"frame_knob_grid res {res} cs {cs} "
                                         f"{case}: the host outlasted the "
                                         f"spin")
                tr_ms, _ = traced_ms(call, REPS)
                call_ms = cuda_ms(call, REPS)
                plain = cuda_ms(lambda: FK.frame_knob_grid_plain(
                    frames, prev, plan, **kw), PLAIN_REPS)
                b_ms, b_by = bound_ms(plan, n, art != (0,))
                row = dict(case=case, frames=n, res=res, cs=cs,
                           knob4=art != (0,), settings=plan.n_settings,
                           payload_mb=plan.n_settings * n
                           * plan.payload_bytes / 1e6,
                           max_abs_err=max_d, mismatch=frac, ms=ms,
                           hidden=hidden, traced_ms=tr_ms, call_ms=call_ms,
                           plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
                rows.append(row)
                print(json.dumps({"group": row}), flush=True)
        del frames, prev, bg, enable
    return rows, worst


def device_busy_s(prof) -> tuple[float, int]:
    """Seconds in which the card ran at least one traced activity
    (kernels, copies, memsets: the union of their intervals) and the
    number of such activities, from a ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    spans = [(e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA
             and e.name() != TICK_LABEL]
    return union_ns(spans) / 1e9, len(spans)


def union_ns(spans) -> int:
    """Nanoseconds covered by the union of (start, end) intervals."""
    busy, end = 0, None
    for s, e in sorted(spans):
        if end is None or s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def kernel_work(plan, frames, bg, enable) -> dict:
    """What ``frame_knob_grid``'s tile kernel does with each (knob4 block,
    output tile, frame) of one call on these inputs, from the inputs alone:
    ``computed``; ``mirrored``, stored by an earlier block that keeps the
    same pixels of that frame (a frame with knob4 disabled); or ``filled``
    without staging, knob4 keeping no pixel of the tile's resize window
    (the kernel's keep-code test, its columns rounded out to 16 bytes).
    Counts windows without chroma rows only (a BGR or gray plan)."""
    import torch
    from repro_torch.kernels import frame_knobs as FK
    ops = plan.operands
    modes = ops.arrays["block_mode"].tolist()
    movers, contours = FK._artifact_masks(frames, bg, thresh=FK.ARTIFACT_THRESH)
    sums = {}
    for mode, m in ((1, movers), (2, contours)):
        c = torch.nn.functional.pad(m.to(torch.int32).cumsum(1).cumsum(2),
                                    (1, 0, 1, 0))
        sums[mode] = c                               # [F, H + 1, W + 1]
    sy, sx = (torch.as_tensor(ops.arrays[k], device=frames.device).long()
              for k in ("src_y", "src_x"))
    if plan.in_w % 16 == 0:
        sx = torch.stack([sx[:, 0] // 16 * 16,
                          torch.clamp((sx[:, 1] + 15) // 16 * 16,
                                      max=plan.in_w)], -1)
    y0, y1 = sy[:, 0, None], sy[:, 1, None]
    x0, x1 = sx[None, :, 0], sx[None, :, 1]
    out = dict(computed=0, mirrored=0, filled=0)
    en = enable.tolist()
    for f in range(frames.shape[0]):
        bits = [b * en[f] for b in modes]
        for a, bit in enumerate(bits):
            if bit in bits[:a]:
                out["mirrored"] += ops.tiles_y * ops.tiles_x
            elif bit == 0:
                out["computed"] += ops.tiles_y * ops.tiles_x
            else:
                c = sums[bit][f]
                kept = c[y1, x1] - c[y0, x1] - c[y1, x0] + c[y0, x0]
                filled = int((kept == 0).sum())
                out["filled"] += filled
                out["computed"] += ops.tiles_y * ops.tiles_x - filled
    return out


def phase_profile(dev) -> dict:
    """Device time per activity (kernel, copy, memset) of a
    ``frame_knob_grid`` call in the group the ``kernels`` line names: BGR,
    full resolution, knob4, 15 settings x 32 frames (the live re-sweep's
    cam0 tail), traced with ``torch.profiler`` over ``REPS`` calls."""
    from repro_torch.configs.mez_edge import CONFIG
    from repro_torch.core import knobs as K
    from repro_torch.core.broker import RECHAR_CLIP_LEN
    from repro_torch.data.camera import CameraConfig, SyntheticCamera
    from repro_torch.kernels import frame_knobs as FK
    cam = SyntheticCamera(CameraConfig(height=H, width=W, dynamics="complex",
                                       seed=CONFIG.seed))
    stream = [cam.next_frame()[1] for _ in range(N_FRAMES)]
    frames, prev, bg, enable = grid_inputs(dev, cam.background,
                                           stream[-RECHAR_CLIP_LEN:])
    plan = FK.build_transform_plan(H, W, scale=1.0, cs=FK.CS_BGR,
                                   blur_ks=K.BLUR_KERNELS,
                                   art_modes=(0, 1, 2))
    ms, stages = traced_ms(lambda: FK.frame_knob_grid(
        frames, prev, plan, background=bg, art_enable=enable, device=dev),
        REPS)
    return dict(group=f"res 0, BGR, knob4, {plan.n_settings} settings x "
                      f"{frames.shape[0]} frames", traced_ms=ms,
                stages=stages, blocks=kernel_work(plan, frames, bg, enable))


def attn_bound_ms(kind: str, dtype, b: int, s: int, qh: int, kh: int,
                  d: int, *, sk: "int | None" = None,
                  causal: bool = True) -> tuple[float, str]:
    """Least time of one attention call on the card: inputs read once and
    the output written once over the memory rate, against 4 FLOP per (q
    head, key, column) pair -- the two products -- over the peak rate of
    the inputs' type (bf16 tensor cores; float32 outside them).  ``kind``
    "flash": ``s`` queries over ``sk`` keys (default ``s``), causal (query
    i sees min(i + 1, sk) keys; s (s + 1) / 2 pairs per q head at sk = s)
    or full (s sk pairs); "decode": one query against the ``s`` valid
    cache rows."""
    import torch
    esz = torch.finfo(dtype).bits // 8
    if kind == "flash":
        sk = s if sk is None else sk
        nbytes = esz * (2 * b * s * qh * d + 2 * b * sk * kh * d)
        pairs = (sum(min(i + 1, sk) for i in range(s)) if causal
                 else s * sk)
    else:
        nbytes = esz * (2 * b * qh * d + 2 * b * s * kh * d)
        pairs = s
    flops = 4.0 * b * qh * d * pairs
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(fn, plain, library) -> dict:
    """Device ms per call (``device_ms`` over ``ATTN_REPS`` calls) of the
    kernel's wrapper, its plain version and the library call, and the
    wrapper's whole call time (CUDA events around one call, median of
    ``REPS``: its host time included).  Raises when the spin did not hide
    the host."""
    out = {}
    for key, f in (("", fn), ("plain_", plain), ("library_", library)):
        ms, hidden = device_ms(f, ATTN_REPS)
        if not hidden:
            raise AssertionError(f"{key}ms: the host outlasted the spin")
        out[f"{key}ms"] = ms
    out["call_ms"] = cuda_ms(fn, REPS)
    return out


def phase_attention(dev, cfg, *, flash_shapes=FLASH_SHAPES,
                    flash_extra=FLASH_EXTRA, decode_s_max=DECODE_S_MAX,
                    decode_lengths=DECODE_LENGTHS) -> list[dict]:
    """Both attention kernels against their plain versions at the heads of
    ``cfg``: flash at ``flash_shapes`` with the config's head dim -- (B, S)
    causal self-attention, or (B, Sq, Sk, causal) --, and in bfloat16 also
    at ``flash_extra`` (B, S, D) causal; decode over a
    ``decode_s_max`` cache at ``decode_lengths``; in float32 and bfloat16
    on seeded unit-normal inputs, each timed (``timed``) beside its plain
    version, SDPA (timed here only, called nowhere in the port) and its
    bound.  Raises when an error passes its tolerance."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    qh, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []

    def record(row, got, want):
        err = float((got.float() - want.float()).abs().max())
        tol = ATTN_TOL[row["kernel"], row["dtype"]]
        row["max_abs_err"] = err
        print(json.dumps({"attention": row}), flush=True)
        if not err <= tol:
            raise AssertionError(f"{row['kernel']} {row['dtype']} "
                                 f"{row['shape']}: max |d| {err} > {tol}")
        rows.append(row)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        # (B, Sq, Sk, D, causal): (B, S) causal self-attention at the
        # config's head dim, or (B, Sq, Sk, causal); extras (B, S, D)
        cases = [(sh[0], sh[1], sh[1], d, True) if len(sh) == 2
                 else (sh[0], sh[1], sh[2], d, sh[3]) for sh in flash_shapes]
        if dtype == torch.bfloat16:
            cases += [(b, s, s, hd, True) for b, s, hd in flash_extra]
        for b, s, sk, hd, causal in cases:
            q = torch.randn((b, s, qh, hd), generator=g, device=dev).to(dtype)
            k = torch.randn((b, sk, kh, hd), generator=g,
                            device=dev).to(dtype)
            v = torch.randn((b, sk, kh, hd), generator=g,
                            device=dev).to(dtype)
            route = FA.flash_route(dtype, hd)
            before = dict(FA.flash_attention.launches_by_route)
            got = FA.flash_attention(q, k, v, causal=causal)
            took = {r: n - before[r] for r, n in
                    FA.flash_attention.launches_by_route.items()}
            if q.is_cuda and took != {r: int(r == route) for r in FA.ROUTES}:
                raise AssertionError(f"flash {name} D={hd}: routes {took}, "
                                     f"want one launch of {route}")
            want = FA.flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            b_ms, b_by = attn_bound_ms("flash", dtype, b, s, qh, kh, hd,
                                       sk=sk, causal=causal)
            lens = f"S={s}" if s == sk else f"Sq={s} Sk={sk}"
            row = dict(
                kernel="flash_attention", dtype=name, kernel_route=route,
                head_dim=hd, group=qh // kh, causal=causal,
                shape=f"B={b} {lens} QH={qh} KH={kh} D={hd} "
                      f"{'causal' if causal else 'full'}",
                **timed(lambda: FA.flash_attention(q, k, v, causal=causal),
                        lambda: FA.flash_attention_plain(q, k, v,
                                                         causal=causal),
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=causal, enable_gqa=True)),
                bound_ms=b_ms, bound_by=b_by)
            record(row, got, want)
            del q, k, v, qt, kt, vt, got, want
        b = SERVE_BATCH
        shape = (b, decode_s_max, kh, d)
        kc = torch.randn(shape, generator=g, device=dev).to(dtype)
        vc = torch.randn(shape, generator=g, device=dev).to(dtype)
        q = torch.randn((b, 1, qh, d), generator=g, device=dev).to(dtype)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
        for length in decode_lengths:
            got = DA.decode_attention(q, kc, vc, length)
            want = DA.decode_attention_plain(q, kc, vc, length)
            torch.cuda.synchronize()
            kv_len = kt[:, :, :length], vt[:, :, :length]
            b_ms, b_by = attn_bound_ms("decode", dtype, b, length, qh, kh, d)
            row = dict(
                kernel="decode_attention", dtype=name, length=length,
                kernel_route="cluster", group=qh // kh, head_dim=d,
                shape=f"B={b} S_max={decode_s_max} QH={qh} KH={kh} D={d} "
                      f"length={length}",
                **timed(lambda: DA.decode_attention(q, kc, vc, length),
                        lambda: DA.decode_attention_plain(q, kc, vc, length),
                        lambda: F.scaled_dot_product_attention(
                            qt, *kv_len, enable_gqa=True)),
                bound_ms=b_ms, bound_by=b_by)
            record(row, got, want)
            del kv_len
        del kc, vc, q, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def phase_model_check(dev, arch: str, *, reduced: bool, batch: int,
                      prompt: int, ref_impl: str, tweak=None, cfg=None,
                      repeat: bool = False, inputs=None) -> dict:
    """The whole model at its published widths in float32, one seed: the
    prefill and ``CHECK_STEPS`` teacher-forced decode steps through the
    kernels (``attention_impl="kernel"``) and through ``ref_impl`` (the
    plain versions), on the same weights and tokens (``build_served``).
    ``cfg`` (a float32 config, e.g. one cut in depth) takes the place of
    ``serve_config(arch)``'s.  ``tweak(params, g)`` may redraw parameters
    first, and ``inputs(cfg, batch)`` add inputs to the prompt batch (the
    VLM's M-RoPE positions).  Last-position logits of the real vocabulary (the padded columns
    hold the mask value) must agree within ``LOGIT_RTOL`` of their max
    |logit| at each step and pick the same greedy token everywhere; with
    ``repeat``, a second kernel run must give the same bits.  For the MoE
    family both runs' routing is recorded (``RouteRecorder``): whether it
    was identical, the smallest gap between the k-th and (k+1)-th router
    probability, and where it first differs, so a near-tie can be told
    from a fault."""
    import dataclasses
    import torch
    from repro_torch.launch.serve import serve_config
    from repro_torch.models.registry import build_model
    if cfg is None:
        cfg = serve_config(arch, reduced=reduced, param_dtype="float32",
                           device=dev)
    model, params, pb, _, g, _ = build_served(dev, cfg, batch=batch,
                                              prompt=prompt)
    if tweak is not None:
        tweak(params, g)
    if inputs is not None:
        pb.update(inputs(cfg, pb))
    forced = torch.randint(0, model.cfg.vocab_size,
                           (batch, CHECK_STEPS), generator=g,
                           device=dev, dtype=torch.int32)

    vocab = model.cfg.vocab_size
    moe = model.cfg.family == "moe"

    # the enc-dec family's cache also holds the prompt's frames
    enc = {"enc_len": prompt} if model.cfg.family == "audio" else {}

    def run(m):
        cache = m.init_cache(batch, prompt + CHECK_STEPS, device=dev, **enc)
        with torch.no_grad(), RouteRecorder(moe) as rec:
            logits, cache = m.prefill(params, pb, cache)
            out = [logits[:, -1, :vocab].float()]
            for t in range(CHECK_STEPS):
                logits, cache = m.decode_step(params, forced[:, t:t + 1],
                                              cache)
                out.append(logits[:, -1, :vocab].float())
        torch.cuda.synchronize()
        return torch.stack(out, 1), rec.calls     # [B, 1 + steps, V]

    t0 = time.monotonic()
    got, got_routes = run(model)
    again = run(model)[0] if repeat else None
    want, want_routes = run(build_model(dataclasses.replace(
        model.cfg, attention_impl=ref_impl)))
    scale = want.abs().amax(-1)             # [B, steps]
    rel = float(((got - want).abs().amax(-1) / scale).max())
    max_abs = float((got - want).abs().max())
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    out = dict(arch=arch, dtype="float32", reference=ref_impl, batch=batch,
               prompt_len=prompt, steps=CHECK_STEPS,
               num_layers=model.cfg.num_layers, max_rel_err=rel,
               limit=LOGIT_RTOL,
               max_abs_err=max_abs, max_abs_logit=float(scale.max()),
               greedy_identical=same, finite=bool(torch.isfinite(got).all()),
               seconds=time.monotonic() - t0)
    if repeat:
        out["repeat_bitwise_identical"] = bool(torch.equal(got, again))
    if moe:
        out["routing"] = route_difference(got_routes, want_routes,
                                          model.cfg.num_layers)
    del model, params, got, want, again, got_routes, want_routes
    torch.cuda.empty_cache()
    if not (out["finite"] and rel <= LOGIT_RTOL and same
            and out.get("repeat_bitwise_identical", True)):
        raise AssertionError(f"full-width float32 check failed: {out}")
    return out


class RouteRecorder:
    """Inside ``with``, each ``models.moe.route`` call (one per MoE layer:
    the prefill's layers, then each decode step's) appends its chosen
    experts ``[B, S, k]`` and its top-(k+1) router probabilities to
    ``calls``; does nothing where ``active`` is false."""

    def __init__(self, active: bool):
        self.active, self.calls = active, []

    def __enter__(self):
        if self.active:
            from repro_torch.models import moe
            self.real = real = moe.route

            def route(params, x, cfg):
                probs, gates, experts = real(params, x, cfg)
                self.calls.append((experts, probs.topk(
                    cfg.num_experts_per_token + 1, dim=-1).values))
                return probs, gates, experts

            moe.route = route
        return self

    def __exit__(self, *exc):
        if self.active:
            from repro_torch.models import moe
            moe.route = self.real


def route_difference(a: list, b: list, n_layers: int) -> dict:
    """Two runs' recorded routing (``RouteRecorder.calls``): whether every
    token chose the same set of experts (the order of a set follows its
    probabilities, which may swap on a near-tie inside the top k and only
    reorders the sum of its contributions) and the same order; the
    smallest gap between the k-th and (k+1)-th router probability in run
    ``a``; and where the sets first differ (layer, step -- 0 the prefill,
    t the t-th decode step --, batch row, token, and that gap there)."""
    gap = min(float((p[..., -2] - p[..., -1]).min()) for _, p in a)
    first, ordered = None, True
    for i, ((ea, pa), (eb, _)) in enumerate(zip(a, b)):
        ordered = ordered and bool((ea == eb).all())
        diff = (ea.sort(-1).values != eb.sort(-1).values).any(-1).nonzero()
        if len(diff):
            bi, ti = (int(v) for v in diff[0])
            first = dict(layer=i % n_layers, step=i // n_layers, batch=bi,
                         token=ti, gap=float(pa[bi, ti, -2]
                                             - pa[bi, ti, -1]))
            break
    return dict(sets_identical=first is None and len(a) == len(b),
                order_identical=ordered and len(a) == len(b),
                calls=len(a), min_topk_gap=gap, first_difference=first)


def serve_kernels(cfg, gen: int) -> dict:
    """The kernels the serving path of ``cfg`` (as served: reduced or cut)
    launches: name -> (the wrapper that counts its launches, the launches
    one ``serve`` of ``gen`` decode steps must make).  The hybrid family
    attends once per invocation of its shared block (every
    ``shared_attn_period`` of its ``num_layers`` Mamba2 layers), not once a
    layer; the enc-dec family's ``num_layers`` encoder layers attend once
    at prefill, and each of its ``num_decoder_layers`` decoder layers twice
    (self and cross) at prefill and at each decode step."""
    n_layers = cfg.num_layers
    if cfg.family == "ssm":
        from repro_torch.kernels import linear_scan as LS
        # every layer's time-mix, at prefill and at each decode step
        return {"wkv_linear_scan": (LS.wkv_linear_scan,
                                    n_layers * (1 + gen))}
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    if cfg.family == "audio":
        n_dec = cfg.num_decoder_layers
        return {"flash_attention": (FA.flash_attention, n_layers + 2 * n_dec),
                "decode_attention": (DA.decode_attention, 2 * n_dec * gen)}
    n_attn = (n_layers // cfg.shared_attn_period if cfg.family == "hybrid"
              else n_layers)
    return {"flash_attention": (FA.flash_attention, n_attn),
            "decode_attention": (DA.decode_attention, n_attn * gen)}


def phase_serve_timed(dev, arch: str, *, reduced: bool, batch: int,
                      prompt: int, gen: int) -> dict:
    """``serve`` at the published widths in the config's bfloat16, after
    an untimed warm-up call at the same batch and prompt length (so the
    timed prefill meets a warm allocator and the GEMM shapes it has run
    before), with the path's kernels' launches counted from zero just
    before it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    cfg = get_config(arch)
    kernels = serve_kernels(cfg.reduced() if reduced else cfg, gen)
    serve(arch, batch=batch, prompt_len=prompt, gen=2, reduced=reduced,
          device=dev)
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in kernels.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
    t0 = time.monotonic()
    out = serve(arch, batch=batch, prompt_len=prompt, gen=gen,
                reduced=reduced, device=dev)
    seconds = time.monotonic() - t0
    launches = {name: fn.launches for name, (fn, _) in kernels.items()}
    routes = {name: dict(fn.launches_by_route)
              for name, (fn, _) in kernels.items()
              if hasattr(fn, "launches_by_route")}
    want = {name: n for name, (_, n) in kernels.items()}
    toks = out["tokens"]
    res = dict(arch=arch, seconds=seconds, batch=batch, prompt_len=prompt,
               gen=gen, prefill_ms=out["prefill_s"] * 1e3,
               decode_p50_ms=out["decode_p50_ms"],
               decode_p95_ms=out["decode_p95_ms"],
               tokens_per_s=out["tokens_per_s"], cache_len=out["cache_len"],
               launches=launches, launches_by_route=routes,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9,
               distinct_tokens=int(len(set(toks.ravel().tolist()))))
    if launches != want:
        raise AssertionError(f"serve launched {launches}, want {want}")
    if "flash_attention" in routes and routes["flash_attention"] != {
            "wgmma": want["flash_attention"], "ffma": 0}:
        # the bf16 serve's prefill (D=128) runs on the tensor cores
        raise AssertionError(f"serve's flash routes {routes}, want every "
                             f"launch on wgmma")
    # the enc-dec family's cache counts its decoder tokens
    n_tok = max(1, prompt // 8) if cfg.family == "audio" else prompt
    if toks.shape != (batch, gen + 1) or out["cache_len"] != n_tok + gen:
        raise AssertionError(f"serve returned tokens {toks.shape}, "
                             f"cache_len {out['cache_len']}")
    return res


def traced(fn, n_top: int, kernels: tuple[str, ...] = (), *,
           split: bool = False) -> dict:
    """One call of ``fn`` traced with ``torch.profiler``: its host-clock ms
    (ending in a synchronise), the card's busy ms (``device_busy_s``) and
    share of it, and device ms per activity name, the ``n_top`` largest;
    ``kernel_ms``: the device ms and count of the activities whose name
    holds each of ``kernels`` as a whole word; with ``split``, where the
    fleet ticks' host time went (``tick_split``)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.monotonic() - t0) * 1e3
    per = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and e.name() != TICK_LABEL):
            t = per.setdefault(e.name(), [0, 0.0])
            t[0] += 1
            t[1] += (e.end_ns() - e.start_ns()) / 1e6
    busy_s, n_act = device_busy_s(prof)
    top = sorted(per.items(), key=lambda kv: -kv[1][1])
    out = dict(ms_traced=host_ms, device_busy_ms=busy_s * 1e3,
               device_busy_share=busy_s * 1e3 / host_ms,
               device_activities=n_act,
               device_ms_total=sum(ms for _, (_, ms) in top),
               activities=[{"activity": k[:120], "count": c, "ms": ms}
                           for k, (c, ms) in top[:n_top]])
    for name in kernels:
        # a whole word: "quantize_cluster" is not "dequantize_cluster"
        hits = [v for k, v in top if re.search(rf"\b{name}\b", k)]
        out.setdefault("kernel_ms", {})[name] = {
            "count": sum(c for c, _ in hits), "ms": sum(ms for _, ms in hits)}
    if split:
        out["tick_split"] = tick_split(prof)
    return out


def api_kind(name: str) -> str:
    """The kind of a CUDA runtime or driver call, by its name."""
    return ("launch" if "Launch" in name else
            "copy" if "Memcpy" in name or "Memset" in name else
            "sync" if "Synchronize" in name else "other_api")


def tick_split(prof) -> dict:
    """Where the host time of each fleet tick (each ``TICK_LABEL`` range
    ``PollMeter`` marks, the tick and the synchronise after it) went, from
    a trace: the CUDA runtime and driver calls inside the range by kind
    (``api_kind``: count and host ms), the rest of its host time
    (``host_other_ms``: Python, NumPy and the framework's dispatch), and
    the card's busy ms inside it; the median of each over the ticks."""
    from torch.autograd import DeviceType
    evs = list(prof.profiler.kineto_results.events())
    ticks = sorted((e.start_ns(), e.end_ns()) for e in evs
                   if e.name() == TICK_LABEL
                   and e.device_type() == DeviceType.CPU)
    calls = [(e.start_ns(), e.end_ns(), api_kind(e.name())) for e in evs
             if e.device_type() == DeviceType.CPU
             and e.name().startswith("cu")]
    acts = [(e.start_ns(), e.end_ns()) for e in evs
            if e.device_type() == DeviceType.CUDA and e.name() != TICK_LABEL]
    kinds = ("launch", "copy", "sync", "other_api")
    rows = []
    for s, e in ticks:
        row = {"host_ms": (e - s) / 1e6, "device_busy_ms": union_ns(
            [(max(a, s), min(b, e)) for a, b in acts if a < e and b > s])
            / 1e6}
        for k in kinds:
            row[f"{k}_calls"], row[f"{k}_ms"] = 0, 0.0
        for a, b, k in calls:
            if a >= s and b <= e:
                row[f"{k}_calls"] += 1
                row[f"{k}_ms"] += (b - a) / 1e6
        row["host_other_ms"] = row["host_ms"] - sum(row[f"{k}_ms"]
                                                    for k in kinds)
        rows.append(row)
    if not rows:
        return {"ticks": 0}
    return {"ticks": len(rows), **{k: statistics.median(r[k] for r in rows)
                                   for k in rows[0]}}


def phase_decode_trace(dev, arch: str, *, reduced: bool, batch: int,
                       prompt: int, gen: int) -> dict:
    """Device time per activity of the bfloat16 prefill at the serving
    shape and of one decode step after it (cache at the prompt's length),
    each traced with ``torch.profiler`` beside its host-clock time.  The
    timed serve before it ran the same shapes in this process, so the
    traced prefill meets warm GEMM plans."""
    import torch
    from repro_torch.launch.serve import prepare
    model, params, pb, cache, _ = prepare(
        arch, batch=batch, prompt_len=prompt, gen=gen, reduced=reduced,
        device=dev)
    out = {}
    with torch.no_grad():
        def prefill():
            out["prefill"] = model.prefill(params, pb, cache)

        torch.cuda.synchronize()
        pre = traced(prefill, 12)
        logits, cache = out["prefill"]
        tok = logits[:, -1].argmax(-1, keepdim=True).int()
        for _ in range(3):                  # warm
            logits, cache = model.decode_step(params, tok, cache)
        torch.cuda.synchronize()
        step = traced(lambda: model.decode_step(params, tok, cache), 25)
    del model, params, cache, out
    torch.cuda.empty_cache()
    return dict(arch=arch, step_ms_traced=step.pop("ms_traced"), **step,
                prefill=pre)


def phase_serve(dev) -> tuple[list[dict], dict]:
    """The serve phase's four steps; returns (attention rows, timed serve)
    and emits one line per step."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(SERVE_ARCH)
    if SERVE_REDUCED:
        cfg = cfg.reduced()
    t0 = time.monotonic()
    rows = phase_attention(dev, cfg)
    emit("serve_kernels", seconds=time.monotonic() - t0, cases=len(rows),
         max_abs_err={f"{k}/{dt}": max(r["max_abs_err"] for r in rows
                                       if r["kernel"] == k
                                       and r["dtype"] == dt)
                      for k in ("flash_attention", "decode_attention")
                      for dt in ("float32", "bfloat16")})
    emit("serve_check", **phase_model_check(
        dev, SERVE_ARCH, reduced=SERVE_REDUCED, batch=CHECK_BATCH,
        prompt=CHECK_PROMPT, ref_impl="naive"))
    kw = dict(reduced=SERVE_REDUCED, batch=SERVE_BATCH, prompt=SERVE_PROMPT,
              gen=SERVE_GEN)
    timed = phase_serve_timed(dev, SERVE_ARCH, **kw)
    emit("serve", **timed)
    t0 = time.monotonic()
    trace = phase_decode_trace(dev, SERVE_ARCH, **kw)
    emit("serve_trace", seconds=time.monotonic() - t0, **trace)
    torch.cuda.empty_cache()
    return rows, timed


def wkv_bound_ms(dtype, b: int, s: int, h: int, kd: int) -> tuple[float, str]:
    """Least time of one wkv scan on the card from an incoming state (as
    the model calls it): r, k, v (the inputs' type), logw, u and the state
    (float32) read once, y (the inputs' type) and the final state
    (float32) written once,
    over the memory rate; against 4 FLOP per (b, t, h, k, v) -- the y
    contraction and the state update -- over the peak rate of the inputs'
    type (bf16 tensor cores; float32 outside them), as ``attn_bound_ms``
    counts."""
    import torch
    esz = torch.finfo(dtype).bits // 8
    n = b * s * h * kd
    state = b * h * kd * kd * 4
    nbytes = 4 * n * esz + 4 * n + 4 * h * kd + 2 * state
    flops = 4.0 * n * kd
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plain_chunk(s: int) -> int:
    """The largest chunk <= ``WKV_PLAIN_CHUNK`` that divides ``s`` (the
    plain version's rule; the kernel takes any length)."""
    return max(c for c in range(1, WKV_PLAIN_CHUNK + 1) if s % c == 0)


def phase_wkv_kernels(dev, cfg) -> list[dict]:
    """The wkv scan kernel against ``wkv_plain`` at ``WKV_SHAPES`` (H and K
    of ``cfg``), float32 and bfloat16 r/k/v, on seeded inputs: r, k, v, u
    unit normal, ``logw = -exp(N(0, 1) - 1)``, state0 zero or unit
    normal.  Errors on y and on the final state as a share of the plain
    result's max |.|, against ``WKV_TOL``.  The serve's prefill (random
    state: the model always passes its state) and decode shapes are timed
    beside the plain version and the bound: the kernel's device time
    behind a spin kernel (``device_ms``); the plain version's the same way
    at decode and with CUDA events per call at prefill, where its ~16
    chunks of einsums keep the card busy far longer than the host takes to
    queue them.  No PyTorch call computes this function, so there is no
    library time."""
    import torch
    from repro_torch.kernels import linear_scan as LS
    h, kd = cfg.num_heads, cfg.head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for b, s, with_state in WKV_SHAPES:
            r, k, v, lw = (torch.randn((b, s, h, kd), generator=g,
                                       device=dev) for _ in range(4))
            r, k, v = r.to(dtype), k.to(dtype), v.to(dtype)
            logw = -torch.exp(lw - 1.0)
            u = torch.randn((h, kd), generator=g, device=dev)
            s0 = (torch.randn((b, h, kd, kd), generator=g, device=dev)
                  if with_state else None)
            chunk = plain_chunk(s)
            y, st = LS.wkv_linear_scan(r, k, v, logw, u, state0=s0)
            yw, stw = LS.wkv_plain(r, k, v, logw, u, state0=s0, chunk=chunk)
            torch.cuda.synchronize()
            y_abs = float((y.float() - yw.float()).abs().max())
            y_rel = y_abs / float(yw.float().abs().max())
            st_rel = float((st - stw).abs().max() / stw.abs().max())
            row = dict(kernel="wkv_linear_scan", dtype=name, b=b, s=s,
                       state0="random" if with_state else "zero",
                       shape=f"B={b} S={s} H={h} K={kd} state0="
                             f"{'random' if with_state else 'zero'}",
                       plain_chunk=chunk, max_abs_err=y_abs,
                       max_rel_err=y_rel, state_max_rel_err=st_rel)
            del y, st, yw, stw
            if with_state and (b, s) in ((RWKV_BATCH, RWKV_PROMPT),
                                         (RWKV_BATCH, 1)):
                ms, hidden = device_ms(lambda: LS.wkv_linear_scan(
                    r, k, v, logw, u, state0=s0), ATTN_REPS)
                if not hidden:
                    raise AssertionError("wkv ms: the host outlasted the "
                                         "spin")

                def plain():
                    return LS.wkv_plain(r, k, v, logw, u, state0=s0,
                                        chunk=chunk)

                if s == 1:
                    plain_ms, hidden = device_ms(plain, ATTN_REPS)
                    if not hidden:
                        raise AssertionError("wkv plain_ms: the host "
                                             "outlasted the spin")
                else:
                    plain_ms = cuda_ms(plain, REPS)
                b_ms, b_by = wkv_bound_ms(dtype, b, s, h, kd)
                row.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None,
                           call_ms=cuda_ms(lambda: LS.wkv_linear_scan(
                               r, k, v, logw, u, state0=s0), REPS))
            print(json.dumps({"wkv": row}), flush=True)
            if not (y_rel <= WKV_TOL[name]
                    and st_rel <= WKV_TOL["state"]):
                raise AssertionError(f"wkv_linear_scan {name} "
                                     f"{row['shape']}: y {y_rel}, state "
                                     f"{st_rel} of max, limits "
                                     f"{WKV_TOL[name]}, {WKV_TOL['state']}")
            rows.append(row)
            del r, k, v, lw, logw, u, s0
    torch.cuda.empty_cache()
    return rows


def rwkv_tweak(params: dict, g) -> None:
    """Redraw the two RWKV-6 parameters the random init leaves idle (the
    bonus ``u`` starts at zero, the decay base ``w0`` at a constant -6):
    u = 0.5 * N(0, 1), w0 ~ U(-4, 0), so the full-width check exercises
    the bonus term and decays from ~0.98 to ~0.37."""
    import torch
    lay = params["layers"]
    lay["u"] = 0.5 * torch.randn(lay["u"].shape, generator=g,
                                 device=lay["u"].device)
    lay["w0"] = -4.0 * torch.rand(lay["w0"].shape, generator=g,
                                  device=lay["w0"].device)


def wkv_kernel_row(rows: list[dict], timed: dict) -> dict:
    """The ``kernels`` line's row of the wkv scan: launches from the timed
    serve, the worst errors of the checks, and the times at the serve's
    prefill shape in bfloat16 (``decode_*``: one decode step's)."""
    pre, dec = (next(r for r in rows if r["dtype"] == "bfloat16"
                     and "ms" in r and r["s"] == s)
                for s in (RWKV_PROMPT, 1))
    return {
        "name": "wkv_linear_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv_linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan.py:73",
        "launches": timed["launches"]["wkv_linear_scan"],
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "bfloat16"),
        "max_abs_err_float32": max(r["max_abs_err"] for r in rows
                                   if r["dtype"] == "float32"),
        "max_rel_err": max(r["max_rel_err"] for r in rows),
        **{k: pre[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")},
        **{f"decode_{k}": dec[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by")},
        "shape": pre["shape"] + " bfloat16 (the serve's prefill); decode_*: "
                 + dec["shape"] + " bfloat16 (one decode step)"}


def phase_serve_rwkv(dev) -> tuple[list[dict], dict]:
    """The serve_rwkv phase's four steps; returns (wkv rows, timed serve)
    and emits one line per step."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(RWKV_ARCH)
    if RWKV_REDUCED:
        cfg = cfg.reduced()
    t0 = time.monotonic()
    rows = phase_wkv_kernels(dev, cfg)
    emit("rwkv_kernels", seconds=time.monotonic() - t0, cases=len(rows),
         max_rel_err={dt: max(r["max_rel_err"] for r in rows
                              if r["dtype"] == dt)
                      for dt in ("float32", "bfloat16")},
         state_max_rel_err=max(r["state_max_rel_err"] for r in rows),
         limits=WKV_TOL)
    emit("rwkv_check", **phase_model_check(
        dev, RWKV_ARCH, reduced=RWKV_REDUCED, batch=RWKV_CHECK_BATCH,
        prompt=RWKV_CHECK_PROMPT, ref_impl="chunked", tweak=rwkv_tweak))
    kw = dict(reduced=RWKV_REDUCED, batch=RWKV_BATCH, prompt=RWKV_PROMPT,
              gen=RWKV_GEN)
    timed = phase_serve_timed(dev, RWKV_ARCH, **kw)
    emit("serve_rwkv", **timed)
    t0 = time.monotonic()
    trace = phase_decode_trace(dev, RWKV_ARCH, **kw)
    emit("serve_rwkv_trace", seconds=time.monotonic() - t0, **trace)
    torch.cuda.empty_cache()
    return rows, timed

def cut_depth(cfg, num_layers: "int | None"):
    """``cfg`` with its depth cut to ``num_layers`` where given (an enc-dec
    config's encoder and decoder each; the widths kept:
    ``launch.dryrun.depth_cut``)."""
    from repro_torch.launch.dryrun import depth_cut
    return depth_cut(cfg, num_layers) if num_layers else cfg


def zoo_config(arch: str, num_layers: "int | None" = None,
               param_dtype: "str | None" = None):
    """``launch.serve.serve_config(arch)`` as it serves on the card
    (``attention_impl="kernel"``), reduced under ``ZOO_REDUCED``, its depth
    cut to ``num_layers`` where given (``cut_depth``)."""
    from repro_torch.launch.serve import serve_config
    return cut_depth(serve_config(arch, reduced=ZOO_REDUCED,
                                  attention_impl="kernel",
                                  param_dtype=param_dtype), num_layers)


def build_served(dev, cfg, *, batch: int, prompt: int, rows: int = 0):
    """``launch.serve.prepare``'s steps on a config it cannot name (one cut
    in depth): the model, parameters and a prompt batch drawn from one
    generator seeded with 0 on ``dev`` and, where ``rows``, a cache of
    that many rows.  Returns (model, params, batch, cache or None,
    generator, the seconds of ``init_params`` and its peak of allocated
    bytes above what was allocated before it)."""
    import torch
    from repro_torch.models.registry import build_model, make_batch
    model = build_model(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = model.init_params(g, device=dev)
    torch.cuda.synchronize()
    init = dict(seconds=time.monotonic() - t0,
                peak_bytes=torch.cuda.max_memory_allocated() - base)
    pb = make_batch(cfg, batch, prompt, generator=g, device=dev)
    cache = model.init_cache(batch, rows, device=dev) if rows else None
    return model, params, pb, cache, g, init


def phase_zoo_serve(dev, arch: str, num_layers: "int | None", *,
                    batch: int = ZOO_BATCH, prompt: int = ZOO_PROMPT,
                    gen: int = ZOO_GEN) -> dict:
    """A timed bfloat16 ``generate(batch, prompt_len=prompt, gen)`` of
    ``arch`` (cut to ``num_layers`` where given), after one untimed
    ``gen=2`` warm-up on the same weights and cache, with the attention
    kernels' launches counted from zero just before it.  The model is
    built by ``build_served`` so the peak of ``init_params`` can be read:
    it must stay within the parameters' bytes plus one layer's largest leaf
    in float32 (the hybrid family's layers are its Mamba2 stack)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import generate
    from repro_torch.models.registry import DECODE_SLACK
    from repro_torch.tree import tree_leaves
    cfg = zoo_config(arch, num_layers)
    model, params, pb, cache, _, init = build_served(
        dev, cfg, batch=batch, prompt=prompt, rows=prompt + gen + DECODE_SLACK)
    init_peak = init["peak_bytes"]
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    slice_f32 = max(t[0].numel() * 4 for t in tree_leaves(
        params["layers"] if "layers" in params else params["mamba"]))
    generate(model, params, pb, cache, gen=2)
    kernels = serve_kernels(cfg, gen)
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in kernels.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
    t0 = time.monotonic()
    out = generate(model, params, pb, cache, gen=gen)
    seconds = time.monotonic() - t0
    launches = {name: fn.launches for name, (fn, _) in kernels.items()}
    want = {name: n for name, (_, n) in kernels.items()}
    routes = dict(FA.flash_attention.launches_by_route)
    want_routes = {r: want["flash_attention"] * (
        r == FA.flash_route(torch.bfloat16, cfg.head_dim)) for r in routes}
    toks = out["tokens"]
    res = dict(arch=arch, num_layers=cfg.num_layers,
               published_layers=zoo_config(arch).num_layers,
               seconds=seconds, batch=batch, prompt_len=prompt,
               gen=gen, prefill_ms=out["prefill_s"] * 1e3,
               decode_p50_ms=out["decode_p50_ms"],
               decode_p95_ms=out["decode_p95_ms"],
               tokens_per_s=out["tokens_per_s"], cache_len=out["cache_len"],
               launches=launches, flash_routes=routes,
               param_gb=param_bytes / 1e9, init_seconds=init["seconds"],
               init_peak_gb=init_peak / 1e9,
               init_peak_limit_gb=(param_bytes + slice_f32) / 1e9,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9,
               distinct_tokens=int(len(set(toks.ravel().tolist()))))
    del model, params, pb, cache, out
    torch.cuda.empty_cache()
    if launches != want or routes != want_routes:
        raise AssertionError(f"{arch}: launched {launches} (flash routes "
                             f"{routes}), want {want} ({want_routes})")
    if init_peak > param_bytes + slice_f32:
        raise AssertionError(f"{arch}: init_params peaked at {init_peak} "
                             f"bytes, over the parameters' {param_bytes} "
                             f"plus one float32 layer leaf {slice_f32}")
    if toks.shape != (batch, gen + 1) or (
            res["cache_len"] != prompt + gen):
        raise AssertionError(f"{arch}: tokens {toks.shape}, cache_len "
                             f"{res['cache_len']}")
    return res


def phase_serve_zoo(dev) -> tuple[list[dict], dict]:
    """The serve_zoo phase: the attention kernels at the zoo's head shapes
    (``zoo_kernels``), the float32 model checks (``zoo_check``, one line an
    arch), the timed serves (``zoo_serve``, one line an arch) and one
    traced moonshot decode step (``zoo_trace``).  Returns (attention rows,
    arch -> timed serve)."""
    import torch
    t0 = time.monotonic()
    rows = []
    for arch in ZOO_HEADS:
        rows += phase_attention(dev, zoo_config(arch),
                                flash_shapes=ZOO_FLASH, flash_extra=())
    off = [r["shape"] for r in rows if r["kernel"] == "flash_attention"
           and r["dtype"] == "bfloat16" and r["kernel_route"] != "wgmma"]
    if off and not ZOO_REDUCED:
        raise AssertionError(f"bf16 flash off the wgmma route: {off}")
    emit("zoo_kernels", seconds=time.monotonic() - t0, cases=len(rows),
         max_abs_err={f"{k}/{dt}/G={gr}": max(
             r["max_abs_err"] for r in rows if r["kernel"] == k
             and r["dtype"] == dt and r["group"] == gr)
             for k in ("flash_attention", "decode_attention")
             for dt in ("float32", "bfloat16")
             for gr in sorted({r["group"] for r in rows})},
         limits={f"{k}/{dt}": v for (k, dt), v in ATTN_TOL.items()})
    for arch, layers in ZOO_CHECK:
        cfg = zoo_config(arch, layers, "float32")
        emit("zoo_check", **phase_model_check(
            dev, arch, reduced=ZOO_REDUCED, batch=CHECK_BATCH,
            prompt=CHECK_PROMPT, ref_impl="naive", cfg=cfg,
            repeat=cfg.family == "moe"))
    serves = {}
    for arch, layers in ZOO_SERVE:
        serves[arch] = phase_zoo_serve(dev, arch, layers)
        emit("zoo_serve", **serves[arch])
    t0 = time.monotonic()
    trace = phase_decode_trace(dev, ZOO_TRACE, reduced=ZOO_REDUCED,
                               batch=ZOO_BATCH, prompt=ZOO_PROMPT,
                               gen=ZOO_GEN)
    emit("zoo_trace", seconds=time.monotonic() - t0, **trace)
    torch.cuda.empty_cache()
    return rows, serves


def decode_lengths_for(prompt: int, gen: int) -> tuple[int, ...]:
    """``DECODE_LENGTHS`` for a serve of ``prompt`` and ``gen``: one row,
    the prompt, the mean and the last decode step's length, and the
    cache's ``prompt + gen + DECODE_SLACK`` rows."""
    from repro_torch.models.registry import DECODE_SLACK
    return (1, prompt, prompt + gen // 2, prompt + gen - 1,
            prompt + gen + DECODE_SLACK)


def mrope_grid_positions(cfg, batch: dict) -> dict:
    """3-stream M-RoPE ids ``[3, B, S]`` for a VLM batch whose first
    ``frontend_tokens`` positions are patches: the patches on a square grid
    of side ``FAM_GRID`` (t = 0, h = i // side, w = i % side; the reduced
    config's 16 patches on a 4 x 4 grid), the text from the largest id plus
    one in all three streams."""
    import torch
    toks = batch["tokens"]
    b, n_text, dev = toks.shape[0], toks.shape[1], toks.device
    n_patch = batch["patch_embeds"].shape[1]
    side = min(FAM_GRID, int(round(n_patch ** 0.5)))
    i = torch.arange(n_patch, device=dev)
    patch = torch.stack([torch.zeros_like(i), i // side, i % side])
    text = (patch.max() + 1 + torch.arange(n_text, device=dev)).expand(3, -1)
    pos = torch.cat([patch, text], dim=1)
    return {"positions": pos[:, None].expand(3, b, -1).contiguous()}


def zamba_tweak(params: dict, g) -> None:
    """Redraw the LoRA ``qb``/``kb``/``vb`` stacks, which the init leaves
    zero (as the JAX init does), so the check runs the LoRA path."""
    import torch
    for k in ("qb", "kb", "vb"):
        t = params["lora"][k]
        t.copy_(torch.randn(t.shape, generator=g, device=t.device) * 0.02)


def phase_serve_families(dev) -> tuple[list[dict], dict]:
    """The serve_families phase: the attention kernels at the families'
    head shapes (``fam_kernels``: flash at each serve's prefill, decode at
    ``decode_lengths_for`` its serve, bfloat16 flash at D = 112 also at
    ``FAM_FLASH_EXTRA``), the float32 model checks (``fam_check``, one line
    an arch), the timed serves (``fam_serve``, one line an arch) and one
    traced zamba2 decode step (``fam_trace``).  Returns (attention rows,
    arch -> timed serve)."""
    import torch
    t0 = time.monotonic()
    rows = []
    for arch, _, prompt in FAM_SERVE:
        cfg = zoo_config(arch)
        extra = FAM_FLASH_EXTRA if cfg.head_dim == 112 else ()
        lengths = decode_lengths_for(prompt, FAM_GEN)
        rows += [dict(r, arch=arch) for r in phase_attention(
            dev, cfg, flash_shapes=((FAM_BATCH, prompt),), flash_extra=extra,
            decode_s_max=lengths[-1], decode_lengths=lengths)]
    off = [r["shape"] for r in rows if r["kernel"] == "flash_attention"
           and r["dtype"] == "bfloat16" and r["kernel_route"] != "wgmma"]
    if off and not ZOO_REDUCED:
        raise AssertionError(f"bf16 flash off the wgmma route: {off}")
    emit("fam_kernels", seconds=time.monotonic() - t0, cases=len(rows),
         max_abs_err={f"{k}/{dt}/{a}": max(
             r["max_abs_err"] for r in rows if r["kernel"] == k
             and r["dtype"] == dt and r["arch"] == a)
             for k in ("flash_attention", "decode_attention")
             for dt in ("float32", "bfloat16")
             for a, _, _ in FAM_SERVE},
         limits={f"{k}/{dt}": v for (k, dt), v in ATTN_TOL.items()})
    for arch, layers, prompt in FAM_CHECK:
        cfg = zoo_config(arch, layers, "float32")
        vlm = cfg.family == "vlm"
        emit("fam_check", **phase_model_check(
            dev, arch, reduced=ZOO_REDUCED, batch=CHECK_BATCH, prompt=prompt,
            ref_impl="naive", cfg=cfg,
            tweak=None if vlm else zamba_tweak,
            inputs=mrope_grid_positions if vlm else None),
            positions="3-stream grid" if vlm else "default")
    serves = {}
    for arch, layers, prompt in FAM_SERVE:
        serves[arch] = phase_zoo_serve(dev, arch, layers, batch=FAM_BATCH,
                                       prompt=prompt, gen=FAM_GEN)
        emit("fam_serve", **serves[arch])
    t0 = time.monotonic()
    prompt = dict((a, p) for a, _, p in FAM_SERVE)[FAM_TRACE]
    trace = phase_decode_trace(dev, FAM_TRACE, reduced=ZOO_REDUCED,
                               batch=FAM_BATCH, prompt=prompt, gen=FAM_GEN)
    emit("fam_trace", seconds=time.monotonic() - t0, **trace)
    torch.cuda.empty_cache()
    return rows, serves


def enc_path(row: dict) -> str:
    """Which prefill attention of the enc-dec serve a flash row of
    ``enc_kernels`` stands for: causal (the decoder's self-attention),
    full over Sq == Sk (the encoder) or full with Sq != Sk (cross)."""
    return ("decoder_self" if row["causal"] else "cross"
            if "Sq=" in row["shape"] else "encoder")


def phase_serve_encdec(dev) -> tuple[list[dict], dict]:
    """The serve_encdec phase: both attention kernels against their plain
    versions at the enc-dec serve's shapes (``enc_kernels``: flash full
    over the encoder's frames, full with the decoder's tokens over the
    frames -- cross, Sq != Sk --, causal over the decoder's tokens; decode
    over the decoder's cache at ``decode_lengths_for``-style lengths and
    over the cross cache at length = S_max = ``ENC_PROMPT``), the float32
    model at ``ENC_CHECK_LAYERS`` + ``ENC_CHECK_LAYERS`` layers with the
    kernels against naive attention (``enc_check``), the timed bfloat16
    ``serve`` at the whole depth (``enc_serve``) and one traced decode step
    (``enc_trace``).  Returns (attention rows, timed serve)."""
    import torch
    from repro_torch.models.registry import DECODE_SLACK
    cfg = zoo_config(ENC_ARCH)
    n_tok = max(1, ENC_PROMPT // 8)
    s_max = ENC_PROMPT + ENC_GEN + DECODE_SLACK
    t0 = time.monotonic()
    rows = [dict(r, path=enc_path(r) if r["kernel"] == "flash_attention"
                 else "decoder_self") for r in phase_attention(
        dev, cfg, flash_shapes=((ENC_BATCH, ENC_PROMPT, ENC_PROMPT, False),
                                (ENC_BATCH, n_tok, ENC_PROMPT, False),
                                (ENC_BATCH, n_tok, n_tok, True)),
        flash_extra=(), decode_s_max=s_max,
        decode_lengths=(1, n_tok, n_tok + ENC_GEN // 2,
                        n_tok + ENC_GEN - 1, s_max))]
    rows += [dict(r, path="cross") for r in phase_attention(
        dev, cfg, flash_shapes=(), flash_extra=(), decode_s_max=ENC_PROMPT,
        decode_lengths=(ENC_PROMPT,))]
    rows = [dict(r, arch=ENC_ARCH) for r in rows]
    off = [r["shape"] for r in rows if r["kernel"] == "flash_attention"
           and r["dtype"] == "bfloat16" and r["kernel_route"] != "wgmma"]
    if off and not ZOO_REDUCED:
        raise AssertionError(f"bf16 flash off the wgmma route: {off}")
    emit("enc_kernels", seconds=time.monotonic() - t0, cases=len(rows),
         max_abs_err={f"{r['kernel']}/{r['dtype']}/{r['path']}": max(
             x["max_abs_err"] for x in rows if x["kernel"] == r["kernel"]
             and x["dtype"] == r["dtype"] and x["path"] == r["path"])
             for r in rows},
         limits={f"{k}/{dt}": v for (k, dt), v in ATTN_TOL.items()})
    ccfg = zoo_config(ENC_ARCH, ENC_CHECK_LAYERS, "float32")
    emit("enc_check", **phase_model_check(
        dev, ENC_ARCH, reduced=ZOO_REDUCED, batch=CHECK_BATCH,
        prompt=ENC_PROMPT, ref_impl="naive", cfg=ccfg),
        num_decoder_layers=ccfg.num_decoder_layers, decoder_tokens=n_tok)
    kw = dict(reduced=ZOO_REDUCED, batch=ENC_BATCH, prompt=ENC_PROMPT,
              gen=ENC_GEN)
    timed = phase_serve_timed(dev, ENC_ARCH, **kw)
    emit("enc_serve", decoder_tokens=n_tok, **timed)
    t0 = time.monotonic()
    trace = phase_decode_trace(dev, ENC_ARCH, **kw)
    emit("enc_trace", seconds=time.monotonic() - t0, **trace)
    torch.cuda.empty_cache()
    return rows, timed


def tf_config(arch: str, layers: "int | None"):
    """``arch``'s published config (reduced under ``ZOO_REDUCED``) as it
    trains -- its own attention impl (``"chunked"``), microbatches and
    remat --, its depth cut to ``layers`` where given (``cut_depth``)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cut_depth(cfg.reduced() if ZOO_REDUCED else cfg, layers)


def phase_train_family(dev, arch: str, layers: "int | None", batch: int,
                       seq: int, *, remat: "str | None" = None,
                       steps: int = TF_STEPS) -> dict:
    """One family's training at its published widths (``tf_config``;
    ``remat`` in place of the config's where given): step 0's gradients
    (the config's microbatches) computed once, each leaf the step's hook
    quantizes sent through the kernels' round trip
    (``make_grad_compressor``, as the step does) and through the plain
    one, bit for bit; then ``steps`` steps of ``build_train_step`` (the
    8-bit hook, AdamW as ``launch/train.py`` runs it) on one repeated
    batch, with the quantize kernels' launches counted from zero just
    before them.  Raises unless the round trips are identical, every
    launch is on the contiguous route, and the losses are finite and
    falling."""
    import numpy as np
    import torch
    from repro_torch.core.approx_comm import make_grad_compressor
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch.steps import (build_train_step, compute_grads,
                                          microbatch_count)
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.tree import tree_items
    import dataclasses
    t0 = time.monotonic()
    cfg = tf_config(arch, layers)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = model.init_params(g, device=dev)
    data = make_batch(cfg, batch, seq, generator=g, device=dev, train=True)
    n_params = sum(t.numel() for _, t in tree_items(params))
    param_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_items(params))
    m = microbatch_count(cfg, batch)
    hook = make_grad_compressor(TRAIN_BITS, min_size=GRAD_MIN_SIZE)

    t1 = time.monotonic()
    loss0, grads = compute_grads(model, params, data, m)
    n0 = (Q.quantize_blocks.launches, Q.dequantize_blocks.launches)
    diffs, leaves = [], 0
    for key, gr in tree_items(grads):
        if gr.numel() >= GRAD_MIN_SIZE:
            leaves += 1
            if not torch.equal(hook({"g": gr})["g"],
                               plain_roundtrip(gr, TRAIN_BITS)):
                diffs.append(key)
    torch.cuda.synchronize()
    check_launches = [Q.quantize_blocks.launches - n0[0],
                      Q.dequantize_blocks.launches - n0[1]]
    grad_dtype = str(tree_items(grads)[0][1].dtype).removeprefix("torch.")
    check_s = time.monotonic() - t1
    del grads, gr           # the loop's last leaf too (2.5 GB for qwen2-vl)
    # the check's cached blocks go back before the moments are allocated
    torch.cuda.empty_cache()

    state = init_opt_state(params, device=dev)
    step = build_train_step(cfg, AdamWConfig(), hook)
    Q.quantize_blocks.launches = Q.dequantize_blocks.launches = 0
    for f in (Q.quantize_blocks, Q.dequantize_blocks):
        f.launches_by_route = dict.fromkeys(Q.ROUTES, 0)
    losses, step_s = [], []
    for _ in range(steps):
        t1 = time.monotonic()
        params, state, metrics = step(params, state, data)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t1)
        losses.append(float(metrics["loss"]))
    launches = {"quantize_blocks": Q.quantize_blocks.launches,
                "dequantize_blocks": Q.dequantize_blocks.launches}
    routes = route_delta({k: dict.fromkeys(Q.ROUTES, 0) for k in launches},
                         route_counts())
    p50 = float(np.percentile(step_s, 50))
    n_tokens = data["tokens"].numel() + sum(
        data[k].shape[0] * data[k].shape[1] for k in ("patch_embeds",
                                                      "embeds") if k in data)
    res = dict(arch=arch, num_layers=cfg.num_layers,
               num_decoder_layers=cfg.num_decoder_layers or None,
               published_layers=tf_config(arch, None).num_layers,
               batch=batch, seq=seq, positions=n_tokens, microbatches=m,
               grad_bits=TRAIN_BITS, attention_impl=cfg.attention_impl,
               remat=cfg.remat,
               params_b=n_params / 1e9, param_gb=param_bytes / 1e9,
               reckoned_gb=n_params * (12 + (4 if m > 1 else 0)) / 1e9,
               step0_loss=float(loss0), grad_dtype=grad_dtype,
               leaves=leaves, check_launches=check_launches,
               roundtrips_bitwise_identical=not diffs, check_seconds=check_s,
               losses=losses, loss_falling=losses[-1] < losses[0],
               step_s=step_s, step_p50_s=p50,
               positions_per_s=n_tokens / p50, launches=launches,
               launches_by_route=routes,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9,
               max_memory_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               seconds=time.monotonic() - t0)
    del model, params, state, data, step
    torch.cuda.empty_cache()
    if diffs or check_launches != [leaves, leaves]:
        raise AssertionError(f"{arch}: step 0's round trips differ at "
                             f"{diffs} ({check_launches} launches, "
                             f"{leaves} leaves)")
    if launches != {k: leaves * steps for k in launches} \
            or routes != contiguous_only(leaves * steps):
        raise AssertionError(f"{arch}: the steps launched {launches} "
                             f"({routes}), want {leaves * steps} of "
                             f"each, all contiguous")
    if not (np.isfinite(losses).all() and res["loss_falling"]):
        raise AssertionError(f"{arch}: losses {losses}")
    return res


def phase_train_families(dev) -> dict:
    """The train_families phase: ``phase_train_family`` for each of
    ``TF_FAMILIES``, one ``train_families`` line each; returns arch ->
    result."""
    out = {}
    for arch, layers, batch, seq in TF_FAMILIES:
        out[arch] = phase_train_family(dev, arch, layers, batch, seq)
        emit("train_families", **out[arch])
    return out


def remat_grads(cfg, params, data) -> dict:
    """``compute_grads`` of one microbatch under ``cfg.remat``, twice from
    an emptied cache: the first call traced (``traced``: the card's busy
    share, its top activities; the allocator's growth in it) and, its
    gradients dropped, the second timed (ending in a synchronise): its
    seconds, its peak allocated over the bytes held just before
    (``reset_peak_memory_stats``, then ``max_memory_allocated``), its loss
    and its gradients."""
    import torch
    from repro_torch.launch.steps import compute_grads
    from repro_torch.models.registry import build_model
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    first = traced(lambda: compute_grads(model, params, data, 1), 4)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    loss, grads = compute_grads(model, params, data, 1)
    torch.cuda.synchronize()
    return {"seconds": time.monotonic() - t0, "first_call_traced": first,
            "peak_over_baseline_gb":
                (torch.cuda.max_memory_allocated() - base) / 1e9,
            "loss": float(loss), "grads": grads}


def remat_reckoned_gb(cfg) -> float:
    """The peak of ``compute_grads`` of one ``REMAT_BATCH x REMAT_SEQ``
    microbatch under ``cfg.remat``, reckoned on the meta device
    (``MetaPass``, as the dry-run reckons a step)."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.steps import compute_grads
    from repro_torch.meta import MetaPass
    from repro_torch.models.registry import (build_model, input_specs,
                                             param_specs)
    params = param_specs(cfg)
    data = input_specs(cfg, ShapeCell("remat", REMAT_SEQ, REMAT_BATCH,
                                      "train"))["batch"]
    watch = MetaPass(exclude=(params, data))
    with watch:
        compute_grads(build_model(cfg), params, data, 1)
    return watch.peak / 1e9


def phase_remat(dev) -> dict:
    """The remat phase: ``REMAT_ARCH`` at its published widths (bf16, its
    training attention), one microbatch of ``REMAT_BATCH x REMAT_SEQ``
    through ``compute_grads`` under each of ``REMAT_POLICIES`` (one
    ``remat`` line each: seconds, the peak over the baseline beside its
    meta reckoning, ``remat_reckoned_gb``); the gradients under ``"dots"``
    and ``"none"`` against those under ``"full"``, leaf by leaf (bitwise
    leaves counted, each within ``REMAT_GRAD_RTOL`` of its norm); then
    ``phase_train_family`` under ``"dots"`` (``REMAT_STEPS`` steps with
    the 8-bit hook, round trips bitwise the plain ones, every launch
    contiguous) and ``examples/torch_train_100m.py``'s ``main`` at its
    defaults (30 steps of 8 x 256; it asserts the loss falls).  Raises
    unless the peaks order as full < dots < none and every leaf is within
    the limit."""
    import dataclasses
    import importlib.util
    import shutil

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.tree import tree_items
    t0 = time.monotonic()
    held_gb = torch.cuda.memory_allocated() / 1e9   # left by earlier phases
    base = tf_config(REMAT_ARCH, None)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = build_model(base).init_params(g, device=dev)
    data = make_batch(base, REMAT_BATCH, REMAT_SEQ, generator=g, device=dev,
                      train=True)
    runs, reckoned = {}, {}
    for remat in REMAT_POLICIES:
        cfg = dataclasses.replace(base, remat=remat)
        reckoned[remat] = remat_reckoned_gb(cfg)
        runs[remat] = remat_grads(cfg, params, data)
    want = dict(tree_items(runs["full"]["grads"]))
    worst, bitwise = {}, {}
    for remat in ("dots", "none"):
        got = dict(tree_items(runs[remat]["grads"]))
        worst[remat] = max(
            float((got[k].float() - w.float()).norm()
                  / w.float().norm().clamp_min(1e-30))
            for k, w in want.items())
        bitwise[remat] = sum(torch.equal(got[k], w) for k, w in want.items())
    peaks = {r: runs[r]["peak_over_baseline_gb"] for r in REMAT_POLICIES}
    for remat in REMAT_POLICIES:
        emit("remat", arch=REMAT_ARCH, reduced=ZOO_REDUCED, remat=remat,
             batch=REMAT_BATCH, seq=REMAT_SEQ, dtype=base.compute_dtype,
             attention_impl=base.attention_impl,
             seconds=runs[remat]["seconds"],
             first_call_traced=runs[remat]["first_call_traced"],
             peak_over_baseline_gb=peaks[remat],
             reckoned_peak_gb=reckoned[remat], loss=runs[remat]["loss"],
             **({"grad_max_rel_err_vs_full": worst[remat],
                 "grad_leaves_bitwise_full": bitwise[remat],
                 "grad_leaves": len(want)} if remat in worst else {}))
    res = dict(seconds=time.monotonic() - t0, allocated_at_start_gb=held_gb,
               peaks_gb=peaks, reckoned_peaks_gb=reckoned,
               dots_minus_full_gb=peaks["dots"] - peaks["full"],
               predicted_dots_minus_full_gb=REMAT_PREDICTED_GB,
               grad_max_rel_err_vs_full=worst,
               grad_leaves_bitwise_full=bitwise, grad_leaves=len(want),
               grad_rtol=REMAT_GRAD_RTOL)
    del runs, want, got, params, data
    torch.cuda.empty_cache()
    if not peaks["full"] < peaks["dots"] < peaks["none"]:
        raise AssertionError(f"remat peaks out of order: {peaks}")
    if not max(worst.values()) <= REMAT_GRAD_RTOL:
        raise AssertionError(f"remat gradients off those under full: "
                             f"{worst}")
    res["train_step"] = phase_train_family(
        dev, REMAT_ARCH, None, REMAT_BATCH, REMAT_SEQ, remat="dots",
        steps=REMAT_STEPS)
    emit("remat_train_step", **res["train_step"])
    t1 = time.monotonic()
    spec = importlib.util.spec_from_file_location("torch_train_100m",
                                                  EXAMPLE_100M)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    ckpt = ROOT / "build" / "chip_smoke_ckpt_100m"
    try:
        out = example.main(["--device", dev.type, "--ckpt", str(ckpt)])
    finally:
        ARCHS.pop("qwen3-100m", None)
        shutil.rmtree(ckpt, ignore_errors=True)
    res["example_100m"] = dict(
        seconds=time.monotonic() - t1, steps=out["steps"],
        first_loss=out["first_loss"], final_loss=out["final_loss"],
        loss_falling=out["final_loss"] < out["first_loss"],
        step_p50_s=statistics.median(out["step_s"]))
    emit("remat_example_100m", **res["example_100m"])
    torch.cuda.empty_cache()
    res["seconds"] = time.monotonic() - t0
    emit("remat_phase", **{k: v for k, v in res.items()
                           if k not in ("train_step", "example_100m")})
    return res


def dryrun_share(got, want) -> float:
    """max |got - want| as a share of max |want|, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def row_rel_err(got, want) -> float:
    """The largest over rows (every index but the last) of ||got - want||
    / ||want||, in float32."""
    import torch
    got, want = got.float(), want.float()
    norm = torch.linalg.vector_norm
    return float((norm(got - want, dim=-1)
                  / norm(want, dim=-1).clamp_min(1e-30)).max())


def tail_attention_plain(q, k, v, rows: int, *, causal: bool = True,
                         scale: "float | None" = None):
    """``flash_attention_plain``'s float32 softmax attention for the last
    ``rows`` query rows only (at S = 32768 they read every key tile), in
    q's dtype: ``[B, rows, QH, D]``."""
    import torch
    sq, qh, d = q.shape[1], q.shape[2], q.shape[3]
    g = qh // k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kx = k.repeat_interleave(g, dim=2).float()
    vx = v.repeat_interleave(g, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q[:, sq - rows:].float(), kx) * scale
    if causal:
        qpos = torch.arange(sq - rows, sq, device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vx).to(q.dtype)


def decode_plain(q, kc, vc, length: int, *, scale: "float | None" = None,
                 heads: int = 8):
    """``decode_attention_plain``, ``heads`` kv heads at a time (its
    float32 copies of a 524288-row cache would take 15 GB at once)."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    g = q.shape[2] // kc.shape[2]
    return torch.cat([DA.decode_attention_plain(
        q[:, :, h * g:(h + heads) * g], kc[:, :, h:h + heads],
        vc[:, :, h:h + heads], length, scale=scale)
        for h in range(0, kc.shape[2], heads)], dim=2)


# Planted faults: each runs the real wrapper (its first argument) on
# arguments changed the way a faulty kernel would read them.
def fault_flash_tile(real, q, k, v, **kw):
    """Flash with its last key tile (64 keys) read from the tile before."""
    kf, vf = k.clone(), v.clone()
    kf[:, -64:], vf[:, -64:] = k[:, -128:-64], v[:, -128:-64]
    return real(q, kf, vf, **kw)


def fault_decode_split(real, q, kc, vc, length, **kw):
    """Decode with the last of its 8 splits skipped."""
    return real(q, kc, vc, length - (length + 7) // 8, **kw)


def fault_decode_rows(real, q, kc, vc, length, **kw):
    """Decode with its last 256 rows skipped."""
    return real(q, kc, vc, length - 256, **kw)


def fault_wkv_chunk(real, r, k, v, logw, u, **kw):
    """The scan with one 16-step chunk's keys (the last but one) read as
    zero."""
    kf = k.clone()
    kf[:, -32:-16] = 0
    return real(r, kf, v, logw, u, **kw)


def fault_wkv_state(real, r, k, v, logw, u, *, state0, **kw):
    """The scan with each head's state read from the next head's."""
    return real(r, k, v, logw, u, state0=state0.roll(1, 1), **kw)


def dryrun_faults(name: str, s: int) -> list:
    """The faults planted in ``name``'s launches at sequence length ``s``
    (a wkv decode step has no chunk to drop: its state is misread)."""
    if name == "flash_attention":
        return [fault_flash_tile]
    if name == "decode_attention":
        return [fault_decode_split, fault_decode_rows]
    return [fault_wkv_chunk if s > 32 else fault_wkv_state]


class LaunchCheck:
    """Inside ``with``, each launch a step makes of the flash, decode and
    wkv kernels is held against the kernel's plain version on the same
    arguments: ``errs[name]`` gathers each launch's ``row_rel_err`` --
    flash on batch row 0's last ``DRYRUN_TAIL_ROWS`` query rows
    (``tail_attention_plain``), decode over the whole cache
    (``decode_plain``), the wkv scan on batch row 0 and every
    ``DRYRUN_SCAN_HEADS``-th head (``wkv_plain`` at chunk
    ``gcd(S, DRYRUN_SCAN_CHUNK)``: its chunks' launches bound it; its
    float32 state under ``"wkv_state"``).
    ``fault`` (kernel name -> a planted fault) runs in place of that
    kernel's launches, held against the plain version of the true
    arguments.  It replaces the models' references to the wrappers
    (``models.attention``'s kernel modules, ``models.rwkv6.wkv``): a
    wrapper counts its launches through its own module's name."""

    def __init__(self, fault: "dict | None" = None):
        self.fault, self.errs = fault or {}, {}

    def __enter__(self):
        import types

        from repro_torch.models import attention as TA
        from repro_torch.models import rwkv6
        fk, dk = TA._flash_kernel, TA._decode_kernel
        self.real = [(TA, "_flash_kernel", fk), (TA, "_decode_kernel", dk),
                     (rwkv6, "wkv", rwkv6.wkv)]
        TA._flash_kernel = types.SimpleNamespace(
            flash_attention=self._wrap("flash_attention",
                                       fk.flash_attention))
        TA._decode_kernel = types.SimpleNamespace(
            decode_attention=self._wrap("decode_attention",
                                        dk.decode_attention))
        rwkv6.wkv = self._wrap("wkv_linear_scan", rwkv6.wkv)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.real:
            setattr(mod, name, real)

    def _wrap(self, name, real):
        plant = self.fault.get(name)

        def call(*args, **kwargs):
            out = (plant(real, *args, **kwargs) if plant
                   else real(*args, **kwargs))
            for key, err in self._hold(name, out, args, kwargs):
                self.errs.setdefault(key, []).append(err)
            return out
        return call

    @staticmethod
    def _hold(name, out, args, kwargs) -> list:
        from repro_torch.kernels import linear_scan as LS
        if name == "flash_attention":
            q, k, v = args
            rows = min(DRYRUN_TAIL_ROWS, q.shape[1])
            want = tail_attention_plain(
                q[:1], k[:1], v[:1], rows, causal=kwargs.get("causal", True),
                scale=kwargs.get("scale"))
            return [(name, row_rel_err(out[:1, -rows:], want))]
        if name == "decode_attention":
            q, kc, vc, length = args
            return [(name, row_rel_err(out, decode_plain(
                q, kc, vc, length, scale=kwargs.get("scale"))))]
        h = slice(None, None, DRYRUN_SCAN_HEADS)
        r, k, v, logw = (t[:1, :, h] for t in args[:4])
        s0 = kwargs.get("state0")
        y, st = LS.wkv_plain(r, k, v, logw, args[4][h],
                             state0=None if s0 is None else s0[:1, h],
                             chunk=math.gcd(r.shape[1], DRYRUN_SCAN_CHUNK))
        return [(name, row_rel_err(out[0][:1, :, h], y)),
                ("wkv_state", row_rel_err(out[1][:1, h], st))]


def dryrun_kernel_rows(dev, cfg, cell, arch: str, *, causal: bool = True,
                       lse: bool = False, tag: str = "dryrun_kernel"
                       ) -> list[dict]:
    """The kernels a cut cell's step launches, at its shapes, bfloat16 on
    seeded unit-normal inputs, held to their plain versions by
    ``row_rel_err`` within ``DRYRUN_ROW_RTOL`` and timed behind the spin
    kernel beside the bound, the plain version (one call, CUDA events: the
    plain versions run for seconds here) and SDPA.  Each planted fault of
    ``dryrun_faults`` must read above the limit, so the check is shown to
    see a skipped split, skipped rows or a misread key tile or chunk.
    Flash at S = 32768: the plain version's float32 scores would take ``B *
    QH * S^2 * 4`` bytes (137 GB at B = 2), so batch row 0 is held, all its
    query rows, against the chunked plain route (``models.attention``,
    ``impl="chunked"``, itself timed as the plain version).  Decode over
    ``seq_len`` of ``seq_len + DECODE_SLACK`` rows.  The wkv scan from a
    zero state at a prefill (the model's prefill state) and from a random
    one at a decode step, against ``wkv_plain`` at chunk
    ``plain_chunk(S)``.  ``causal=False``: flash's full attention (an
    encoder's).  ``lse``: decode with its log-sum-exp (a partitioned
    step's route), the output also the same bits as the launch without
    it, the log-sum-exps within ``LSE_RTOL`` of the plain version's row
    by row, and the log-sum-exps shifted by one row read past that limit;
    the launch timed is the one with it.  The row is printed under
    ``tag``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import linear_scan as LS
    from repro_torch.models import attention as TA
    from repro_torch.models.registry import DECODE_SLACK
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    bf16 = torch.bfloat16
    b, s = cell.global_batch, cell.seq_len
    qh, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    limit = DRYRUN_ROW_RTOL["bfloat16"]

    def normal(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def once_ms(fn) -> float:
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)

    def device_only(fn) -> float:
        ms, hidden = device_ms(fn, ATTN_REPS)
        if not hidden:
            raise AssertionError("the host outlasted the spin")
        return ms

    def faults(name, real, want, args, kw, pick=lambda out: out) -> dict:
        """Each planted fault's reading against the sound ``want``."""
        return {" ".join(f.__doc__.split()).rstrip("."): row_rel_err(
            pick(f(real, *args, **kw)), want)
            for f in dryrun_faults(name, s)}

    if cfg.family == "ssm":
        h, kd = cfg.num_heads, cfg.head_dim
        s = 1 if cell.kind == "decode" else s
        r, k, v = normal(b, s, h, kd), normal(b, s, h, kd), \
            normal(b, s, h, kd)
        logw = -torch.exp(normal(b, s, h, kd, dtype=torch.float32) - 1.0)
        u = normal(h, kd, dtype=torch.float32)
        s0 = normal(b, h, kd, kd, dtype=torch.float32) if s == 1 else None
        chunk = plain_chunk(s)
        y, st = LS.wkv_linear_scan(r, k, v, logw, u, state0=s0)
        yw, stw = LS.wkv_plain(r, k, v, logw, u, state0=s0, chunk=chunk)
        kw = {"state0": s0} if s0 is not None else {}
        planted = faults("wkv_linear_scan", LS.wkv_linear_scan, yw,
                         (r, k, v, logw, u), kw, pick=lambda out: out[0])
        torch.cuda.synchronize()
        b_ms, b_by = wkv_bound_ms(bf16, b, s, h, kd)
        row = dict(
            kernel="wkv_linear_scan", arch=arch, cell=cell.name,
            shape=f"B={b} S={s} H={h} K={kd} state0="
                  f"{'random' if s0 is not None else 'zero'} bfloat16",
            max_abs_err=float((y.float() - yw.float()).abs().max()),
            max_row_rel_err=row_rel_err(y, yw),
            state_max_row_rel_err=row_rel_err(st, stw),
            limits=[limit, DRYRUN_ROW_RTOL["state"]], faults=planted,
            ms=device_only(lambda: LS.wkv_linear_scan(r, k, v, logw, u,
                                                      state0=s0)),
            plain_ms=once_ms(lambda: LS.wkv_plain(r, k, v, logw, u,
                                                  state0=s0, chunk=chunk)),
            plain="wkv_plain", bound_ms=b_ms, bound_by=b_by,
            library_ms=None)
        ok = row["state_max_row_rel_err"] <= DRYRUN_ROW_RTOL["state"]
        del r, k, v, logw, u, s0, y, st, yw, stw
    elif cell.kind == "prefill":
        q, k, v = normal(b, s, qh, d), normal(b, s, kh, d), \
            normal(b, s, kh, d)
        route = FA.flash_route(bf16, d)
        got = FA.flash_attention(q, k, v, causal=causal)
        want = TA.gqa_attention(q[:1], k[:1], v[:1], causal=causal,
                                impl="chunked")
        planted = faults("flash_attention", FA.flash_attention, want,
                         (q[:1], k[:1], v[:1]), {"causal": causal})
        torch.cuda.synchronize()
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        b_ms, b_by = attn_bound_ms("flash", bf16, b, s, qh, kh, d,
                                   causal=causal)
        row = dict(
            kernel="flash_attention", arch=arch, cell=cell.name,
            kernel_route=route,
            shape=f"B={b} S={s} QH={qh} KH={kh} D={d} "
                  f"{'causal' if causal else 'full'} bfloat16",
            max_abs_err=float((got[:1].float() - want.float()).abs().max()),
            max_row_rel_err=row_rel_err(got[:1], want), limit=limit,
            faults=planted,
            ms=device_only(lambda: FA.flash_attention(q, k, v,
                                                      causal=causal)),
            plain_ms=once_ms(lambda: TA.gqa_attention(
                q[:1], k[:1], v[:1], causal=causal, impl="chunked")),
            plain="chunked route, batch row 0",
            library_ms=device_only(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by)
        ok = True
        del q, k, v, got, want, qt, kt, vt
    else:
        s_max = s + DECODE_SLACK
        q = normal(b, 1, qh, d)
        kc, vc = normal(b, s_max, kh, d), normal(b, s_max, kh, d)
        got = DA.decode_attention(q, kc, vc, s)
        want = decode_plain(q, kc, vc, s)
        planted = faults("decode_attention", DA.decode_attention, want,
                         (q, kc, vc, s), {})
        extra = {}
        if lse:
            with_lse, got_lse = DA.decode_attention(q, kc, vc, s,
                                                    return_lse=True)
            _, want_lse = DA.decode_attention_plain(q, kc, vc, s,
                                                    return_lse=True)
            shifted = got_lse.reshape(-1).roll(1).reshape(got_lse.shape)
            extra = dict(same_output=bool(torch.equal(with_lse, got)),
                         lse_rel_err=lse_rel_err(got_lse, want_lse),
                         lse_limit=LSE_RTOL,
                         fault_shifted_row=lse_rel_err(shifted, want_lse))
            del with_lse, got_lse, want_lse, shifted
        torch.cuda.synchronize()
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x[:, :s].transpose(1, 2).contiguous() for x in (kc, vc))
        b_ms, b_by = attn_bound_ms("decode", bf16, b, s, qh, kh, d)
        row = dict(
            kernel="decode_attention", arch=arch, cell=cell.name,
            shape=f"B={b} S_max={s_max} QH={qh} KH={kh} D={d} "
                  f"length={s} bfloat16" + (" lse" if lse else ""),
            max_abs_err=float((got.float() - want.float()).abs().max()),
            max_row_rel_err=row_rel_err(got, want), limit=limit,
            faults=planted, **extra,
            ms=device_only(lambda: DA.decode_attention(
                q, kc, vc, s, return_lse=lse)),
            plain_ms=once_ms(lambda: DA.decode_attention_plain(q, kc, vc,
                                                               s)),
            plain="decode_attention_plain",
            library_ms=device_only(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by)
        ok = not lse or (extra["same_output"]
                         and extra["lse_rel_err"] <= LSE_RTOL
                         < extra["fault_shifted_row"])
        del q, kc, vc, got, want, qt, kt, vt
    torch.cuda.empty_cache()
    print(json.dumps({tag: row}), flush=True)
    ok = ok and row["max_row_rel_err"] <= limit and all(
        e > limit for e in row["faults"].values())
    if not ok:
        raise AssertionError(f"{row['kernel']} at {arch} {cell.name}: {row}")
    return [row]


def dryrun_cut(dev, arch: str, shape: str, batch: "int | None",
               layers: "int | None") -> dict:
    """One cell of ``SHAPE_CELLS`` cut to ``batch`` and ``layers``, served
    on the card: its kernels at its shapes (``dryrun_kernel_rows``), then
    the step (``launch.dryrun.cell_bundle``: ``build_prefill_step`` /
    ``build_serve_step``) through the kernel routes on random weights (the
    idle rwkv6 ``u``/``w0`` and zamba2 LoRA ``*b`` redrawn) and a cache
    from ``card_args`` (a decode cell's filled with unit-normal keys,
    values and states at ``length = seq_len``), with every launch counted,
    held against the same step on the plain routes by
    ``launch.dryrun.card_compare`` (a prefill on its first
    ``DRYRUN_PLAIN_ROWS`` prompts): logits and what the step writes into
    the cache within ``STEP_RTOL`` relative RMS of the plain step's.
    Then the kernel step twice more on the plain step's rows: under
    ``LaunchCheck``, each launch within ``DRYRUN_ROW_RTOL`` of its plain
    version on the same arguments, and with a fault of ``dryrun_faults``
    planted in every launch, which the check must see (its smallest and
    largest reading over the launches and how many launches read above
    the limit are printed: on the step's own activations a layer may
    attend where the fault does not reach); that run's logits and cache
    beside the plain step's are printed too, and for the
    ``DRYRUN_STEP_FAULTS`` cuts must lie past ``STEP_RTOL``.
    Beside each run its ``torch.cuda.max_memory_allocated``, its measured
    bytes (``card_run``'s ``step_bytes``) and the meta pass's reckoning of
    the same cut on the plain routes (``launch.dryrun.account``)."""
    import dataclasses

    import torch
    from repro_torch.configs import SHAPE_CELLS, get_config
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import linear_scan as LS
    from repro_torch.launch import dryrun as TD
    from repro_torch.meta import distinct_bytes
    t0 = time.monotonic()
    cfg = get_config(arch)
    if DRYRUN_REDUCED:
        cfg = cfg.reduced()
    cfg = cut_depth(cfg, layers)
    cell = SHAPE_CELLS[shape]
    cell = dataclasses.replace(cell, global_batch=batch or cell.global_batch,
                               seq_len=DRYRUN_SEQ.get(shape, cell.seq_len))
    kernels = dryrun_kernel_rows(dev, cfg, cell, arch)
    kernels_s = time.monotonic() - t0
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    bundle = TD.cell_bundle(cfg, cell, impl="kernel", device=dev)
    args = TD.card_args(cfg, bundle, cell, g)
    if cfg.family == "ssm":
        rwkv_tweak(args[0], g)
    if cfg.family == "hybrid":
        zamba_tweak(args[0], g)
    names = ("flash_attention", "decode_attention", "wkv_linear_scan")
    wrappers = (FA.flash_attention, DA.decode_attention, LS.wkv_linear_scan)
    for w in wrappers:
        w.launches = 0
    FA.flash_attention.launches_by_route = dict.fromkeys(FA.ROUTES, 0)
    both = TD.card_compare(cfg, cell, args, rows=DRYRUN_PLAIN_ROWS,
                           device=dev)
    launches = {n: w.launches for n, w in zip(names, wrappers)}
    want = {"prefill": {"flash_attention": cfg.num_layers},
            "decode": {"decode_attention": cfg.num_layers}}[cell.kind]
    if cfg.family == "ssm":
        want = {"wkv_linear_scan": cfg.num_layers}
    if cfg.family == "hybrid":
        want = {"decode_attention" if cell.kind == "decode"
                else "flash_attention":
                cfg.num_layers // cfg.shared_attn_period}
    if launches != {n: want.get(n, 0) for n in names}:
        raise AssertionError(f"{arch} {shape}: launches {launches}, want "
                             f"{want}")
    if launches["flash_attention"] and not DRYRUN_REDUCED and (
            FA.flash_attention.launches_by_route["wgmma"]
            != launches["flash_attention"]):
        raise AssertionError(f"flash off wgmma: "
                             f"{FA.flash_attention.launches_by_route}")
    run, plain, rows = both["kernel"], both["plain"], both["rows"]
    pcfg, pcell, want = both["plain_cfg"], both["plain_cell"], both["want"]
    errs = both["rel_rms"]
    max_share = {k: dryrun_share(t, want[k]) for k, t in both["got"].items()}
    # each launch held in the step against its plain version, then a fault
    # planted in every launch: the check must see it
    t1 = time.monotonic()
    with LaunchCheck() as sound:
        TD.card_run(cfg, pcell, impl="kernel", generator=g,
                    args=both["again"](), device=dev)
    plant = {n: dryrun_faults(n, 1 if cell.kind == "decode"
                              else cell.seq_len)[0] for n in names}
    with LaunchCheck(fault=plant) as faulty:
        frun = TD.card_run(cfg, pcell, impl="kernel", generator=g,
                           args=both["again"](), device=dev)
    fault_errs = {k: TD.rel_rms(t, want[k])
                  for k, t in both["outputs"](frun["out"]).items()}
    checks_s = time.monotonic() - t1
    held = {k: max(e) for k, e in sound.errs.items()}
    limit = DRYRUN_ROW_RTOL["bfloat16"]
    seen = {k: [round(min(e), 6), round(max(e), 6),
                sum(x > limit for x in e)]
            for k, e in faulty.errs.items() if k != "wkv_state"}
    checked = {k: len(e) for k, e in sound.errs.items() if k in names}
    reckoned = TD.account(cfg, cell)["total_bytes"]
    reckoned_plain = TD.account(pcfg, pcell)["total_bytes"]
    out = dict(
        arch=arch, cell=shape, batch=cell.global_batch,
        cell_batch=SHAPE_CELLS[shape].global_batch, seq_len=cell.seq_len,
        layers=cfg.num_layers, cell_layers=get_config(arch).num_layers,
        cut=f"batch {cell.global_batch} of "
            f"{SHAPE_CELLS[shape].global_batch}, {cfg.num_layers} of "
            f"{get_config(arch).num_layers} layers",
        cache_bytes=distinct_bytes(args[2]), launches=launches,
        kernel_step_s=run["seconds"], plain_step_s=plain["seconds"],
        kernels_s=kernels_s, checks_s=checks_s,
        plain_rows=rows, rel_rms_err=errs, max_share_err=max_share,
        limit=TD.STEP_RTOL, launch_row_rel_err=held,
        launch_limits=DRYRUN_ROW_RTOL, launches_checked=checked,
        faults={n: " ".join(f.__doc__.split()) for n, f in plant.items()
                if launches[n]},
        fault_launch_row_rel_err=seen, fault_rel_rms_err=fault_errs,
        kernel_step_bytes=run["step_bytes"], reckoned_bytes=reckoned,
        plain_step_bytes=plain["step_bytes"],
        reckoned_plain_bytes=reckoned_plain,
        kernel_max_memory_allocated=run["max_memory_allocated"],
        plain_max_memory_allocated=plain["max_memory_allocated"],
        kernels=kernels)
    del run, plain, frun, both, want, args
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t0
    emit("dryrun_cut", **out)
    bad = {k: e for k, e in errs.items() if not e <= TD.STEP_RTOL}
    bad.update({f"launch {k}": e for k, e in held.items()
                if not e <= DRYRUN_ROW_RTOL[
                    "state" if k == "wkv_state" else "bfloat16"]})
    bad.update({f"fault unseen in {k}": e for k, e in seen.items()
                if not e[2]})
    if checked != {n: c for n, c in launches.items() if c}:
        bad["launches checked"] = checked
    if (arch, shape) in DRYRUN_STEP_FAULTS and not max(
            fault_errs.values()) > TD.STEP_RTOL:
        bad["fault unseen in the step"] = fault_errs
    if bad:
        raise AssertionError(f"{arch} {shape}: kernel step off the plain "
                             f"step: {bad}")
    return out


def dryrun_launches(dry: dict, name: str) -> int:
    """``name``'s launches over the dryrun phase's cut steps."""
    return sum(c["launches"][name] for c in dry["cut_results"])


def dryrun_shapes(dry: dict, name: str) -> list[dict]:
    """``name``'s rows at the cut cells' shapes, with its launches in each
    cell's kernel step."""
    return [dict(k, launches_in_step=c["launches"][name])
            for c in dry["cut_results"] for k in c["kernels"]
            if k["kernel"] == name]


def phase_dryrun(dev) -> dict:
    """The dryrun phase: (a) ``python -m repro_torch.launch.dryrun`` in a
    subprocess (no card, ``DRYRUN_JOBS`` workers), every runnable (arch x
    shape) cell accounted on the meta device -- 32 ok, 0 failed, 8
    skipped, one ``dryrun_meta`` line a cell from its JSON --, while (b)
    ``dryrun_cut`` serves the ``DRYRUN_CELLS`` cuts on the card.  Returns
    the cut results and the meta summary."""
    import os
    import signal

    import repro_torch
    from repro_torch.configs import ARCHS, cells_for, skipped_cells_for
    t0 = time.monotonic()
    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    src = Path(repro_torch.__file__).resolve().parents[1]
    archs = [DRYRUN_META_ARCH] if DRYRUN_META_ARCH else list(ARCHS)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
           str(out_dir), "--force", "--jobs", str(DRYRUN_JOBS)]
    if DRYRUN_META_ARCH:
        cmd += ["--arch", DRYRUN_META_ARCH]
    env = dict(os.environ, PYTHONPATH=str(src), CUDA_VISIBLE_DEVICES="")
    # its own session, so its pool's workers go with it on a failure
    meta = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        cuts = [dryrun_cut(dev, *c) for c in DRYRUN_CELLS]
        cut_s = time.monotonic() - t0
        text, _ = meta.communicate(timeout=DRYRUN_META_TIMEOUT_S)
    finally:
        if meta.poll() is None:
            os.killpg(meta.pid, signal.SIGKILL)
            meta.wait()
    n_cells = sum(len(cells_for(a)) for a in archs)
    n_skip = sum(len(skipped_cells_for(a)) for a in archs)
    summary = f"dry-run: {n_cells} ok, 0 failed, {n_skip} skipped"
    if meta.returncode != 0 or summary not in text:
        raise AssertionError(f"meta dry-run: rc {meta.returncode}, want "
                             f"{summary!r}:\n{text[-4000:]}")
    records = []
    for arch in archs:
        for shape in cells_for(arch):
            rec = json.loads((out_dir / f"{arch}__{shape}.json").read_text())
            rec = {k: rec[k] for k in (
                "arch", "shape", "param_bytes", "input_bytes",
                "opt_state_bytes", "output_bytes", "peak_temp_bytes",
                "total_bytes", "flops", "bytes_accessed", "transcendentals",
                "fits_one_card", "cut", "seconds")
                if k in rec}
            print(json.dumps({"dryrun_meta": rec}), flush=True)
            records.append(rec)
    meta_s = max(r["seconds"] for r in records)
    out = dict(seconds=time.monotonic() - t0, cuts_seconds=cut_s,
               meta_summary=summary, meta_cells=len(records),
               meta_longest_cell_s=meta_s,
               meta_cell_s_sum=sum(r["seconds"] for r in records),
               cuts=[{k: c[k] for k in ("arch", "cell", "cut", "seconds",
                                        "kernel_step_s", "rel_rms_err",
                                        "launch_row_rel_err",
                                        "fault_launch_row_rel_err",
                                        "fault_rel_rms_err",
                                        "kernel_step_bytes",
                                        "kernel_max_memory_allocated",
                                        "reckoned_bytes", "plain_rows",
                                        "plain_step_bytes",
                                        "reckoned_plain_bytes")}
                     for c in cuts])
    emit("dryrun", **out)
    out["cut_results"] = cuts
    return out


def grad_leaves(cfg) -> list[tuple[str, tuple[int, int], int]]:
    """The gradient leaves the step's hook quantizes (at least
    ``GRAD_MIN_SIZE`` elements): (key, the padded 2-D shape
    ``approx_comm._pad_2d`` gives it, its element count)."""
    import math
    from repro_torch.models.transformer import param_shapes
    from repro_torch.tree import tree_items
    tile = QUANT_BLOCK[0] * QUANT_BLOCK[1]
    out = []
    for key, shape in tree_items(param_shapes(cfg)):
        n = math.prod(shape)
        if n >= GRAD_MIN_SIZE:
            rows = -(-n // tile) * QUANT_BLOCK[0]
            out.append((key, (rows, QUANT_BLOCK[1]), n))
    return out


def quant_bound_ms(dtype, rows: int, cols: int) -> tuple[float, str]:
    """Least time of one quantize or dequantize call on the card: the input
    read once and the output written once (``x`` in ``dtype``, q one byte,
    one float32 scale per tile: the same bytes either way) over the memory
    rate, against 4 float32 operations per element (a compare, a divide, a
    round, a clip) over the float32 rate."""
    import torch
    n = rows * cols
    esz = torch.finfo(dtype).bits // 8
    tiles = (rows // min(QUANT_BLOCK[0], rows)) * (
        cols // min(QUANT_BLOCK[1], cols))
    nbytes = n * esz + n + 4 * tiles
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * n / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def quant_input(dev, g, rows: int, cols: int, dtype):
    """Gradient-like ``[rows, cols]``: unit normal times one scale per
    256-row band, from 1e-8 to 1e4."""
    import torch
    bands = max(1, rows // QUANT_BLOCK[0])
    x = torch.randn((bands, rows // bands, cols), generator=g, device=dev)
    x *= 10.0 ** (torch.rand((bands, 1, 1), generator=g, device=dev) * 12
                  - 8)
    return x.reshape(rows, cols).to(dtype)


def quant_edge_input(dev):
    """[512, 1024]: an all-zero tile; .5 ties at absmax 127 (scale exactly
    1 at bits 8); .5 ties at absmax 7 (scale 1 at bits 4); values at
    +-absmax."""
    import torch
    x = torch.zeros((512, 1024), device=dev)
    n = 256 * 512
    ar = torch.arange(n, device=dev)
    x[:256, 512:] = ((ar % 254) - 127 + 0.5).float().reshape(256, 512)
    x[0, 512] = 127.0
    x[256:, :512] = ((ar % 14) - 7 + 0.5).float().reshape(256, 512)
    x[256, 0] = -7.0
    col = torch.arange(512, device=dev) % 3
    x[256:, 512:] = torch.where(col == 0, 3.25,
                                torch.where(col == 1, -3.25, 0.0))
    return x


def route_counts() -> "dict | None":
    """Both quantize wrappers' launches per route (copies), or None where
    the wrappers count no routes (a checkout before the routes, timed with
    ``--quant-only --src``)."""
    from repro_torch.kernels import quantize as Q
    if not hasattr(Q.quantize_blocks, "launches_by_route"):
        return None
    return {f.__name__: dict(f.launches_by_route)
            for f in (Q.quantize_blocks, Q.dequantize_blocks)}


def route_delta(before, after) -> "dict | None":
    """Launches per wrapper and route between two ``route_counts``, the
    routes launched only."""
    if before is None or after is None:
        return None
    return {k: {r: n - before[k][r] for r, n in v.items() if n != before[k][r]}
            for k, v in after.items()}


def contiguous_only(n: int) -> dict:
    """``route_delta`` of ``n`` launches of each wrapper, all on the
    contiguous route: what the training path must show."""
    return {"quantize_blocks": {"contiguous": n},
            "dequantize_blocks": {"contiguous": n}}


def quant_check(x, bits: int) -> int:
    """Both kernels against their plain versions on ``x``; raises unless
    q, the scales and the dequantized output (in x's dtype and in float32)
    are bitwise equal, and unless every launch took the route
    ``route_for`` names.  Returns the number of elements compared."""
    import torch
    from repro_torch.kernels import quantize as Q
    before = route_counts()
    q, s = Q.quantize_blocks(x, block=QUANT_BLOCK, bits=bits)
    qp, sp = Q.quantize_blocks_plain(x, block=QUANT_BLOCK, bits=bits)
    torch.cuda.synchronize()
    if not (torch.equal(q, qp) and torch.equal(s, sp)):
        dq = int((q.int() - qp.int()).abs().max())
        raise AssertionError(f"quantize_blocks {tuple(x.shape)} {x.dtype} "
                             f"bits {bits}: q or scales differ from plain "
                             f"(max |dq| {dq})")
    del qp, sp
    outs = {x.dtype, torch.float32}
    for out in outs:
        d = Q.dequantize_blocks(q, s, block=QUANT_BLOCK, out_dtype=out)
        dp = Q.dequantize_blocks_plain(q, s, block=QUANT_BLOCK, out_dtype=out)
        torch.cuda.synchronize()
        if not torch.equal(d, dp):
            raise AssertionError(f"dequantize_blocks {tuple(x.shape)} {out} "
                                 f"bits {bits}: differs from plain")
        del d, dp
    delta = route_delta(before, route_counts())
    if delta is not None:
        route = Q.route_for(x.shape, QUANT_BLOCK)
        want = {"quantize_blocks": {route: 1},
                "dequantize_blocks": {route: len(outs)}}
        if delta != want:
            raise AssertionError(f"{tuple(x.shape)}: launches per route "
                                 f"{delta}, want {want}")
    return x.numel()


def misaligned(x):
    """A copy of ``x`` whose storage starts one element past a 16-byte
    boundary (contiguous, the same shape): the kernels' one-element path."""
    buf = x.new_empty(x.numel() + 1)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def library_dequantize(q, s):
    """One PyTorch call computing ``dequantize_blocks`` to float32: the
    int8 q times its tile's scale, broadcast over the block view (type
    promotion makes it one rounded float32 product).  The yardstick only:
    the port never calls it."""
    import torch
    m, n = q.shape
    bm, bn = min(QUANT_BLOCK[0], m), min(QUANT_BLOCK[1], n)
    return torch.mul(q.view(m // bm, bm, n // bn, bn),
                     s.view(m // bm, 1, n // bn, 1)).view(m, n)


def phase_quant_kernels(dev, cfg) -> dict:
    """The quantize pair against the plain versions at every gradient leaf
    shape of ``cfg``'s step (float32: what a step of several microbatches
    feeds; bfloat16: a one-microbatch step), bits 8 and 4, at
    ``QUANT_EXTRA_SHAPES``, on a misaligned copy and on the edge cases;
    then device times (``device_ms`` behind the spin kernel) of the
    largest leaf and of the step's 13 + 13 launches (float32, bits 8),
    each leaf's too with its GB/s, beside the plain versions' (CUDA events
    per call), the ``torch.mul`` library call's for dequantize (held
    bitwise to the plain version), the wrappers' call ms and the bounds."""
    import torch
    from repro_torch.kernels import quantize as Q
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    leaves = grad_leaves(cfg)
    shapes = sorted({shape for _, shape, _ in leaves})
    cases = elements = 0
    before = route_counts()
    for rows, cols in (*shapes, *QUANT_EXTRA_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x = quant_input(dev, g, rows, cols, dtype)
            for bits in (8, 4):
                elements += quant_check(x, bits)
                cases += 1
            del x
            torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        x = misaligned(quant_input(dev, g, *QUANT_EXTRA_SHAPES[0], dtype))
        elements += quant_check(x, 8)
        q, s = Q.quantize_blocks(x, block=QUANT_BLOCK)
        qm = misaligned(q)
        for out in {dtype, torch.float32}:
            if not torch.equal(
                    Q.dequantize_blocks(qm, s, block=QUANT_BLOCK,
                                        out_dtype=out),
                    Q.dequantize_blocks_plain(q, s, block=QUANT_BLOCK,
                                              out_dtype=out)):
                raise AssertionError(f"dequantize_blocks of a misaligned q "
                                     f"to {out} differs from plain")
        cases += 1
        del x, q, s, qm
    edge = quant_edge_input(dev)
    for bits in (8, 4):
        for dtype in (torch.float32, torch.bfloat16):
            elements += quant_check(edge.to(dtype), bits)
            cases += 1
    q, s = Q.quantize_blocks(edge, block=QUANT_BLOCK, bits=8)
    if float(s[0, 0]) != float(torch.tensor(1e-12)) or q[:256, :512].any():
        raise AssertionError("the all-zero tile: scale or q wrong")
    del edge, q, s
    routes = route_delta(before, route_counts())

    def gbps(x, ms):
        return quant_bound_ms(torch.float32, *x.shape)[0] * HBM_BYTES_PER_S \
            / 1e3 / ms / 1e6

    def timed_pair(xs, keys=None):
        """The kernels' and the library call's device ms behind the spin
        kernel (of each leaf too, with ``keys``); the plain versions' with
        CUDA events per call (their many full-size passes and allocations
        keep the card busy far longer than the host takes to queue them,
        and the spin cannot hide a whole step's worth)."""
        qs = [Q.quantize_blocks(x, block=QUANT_BLOCK) for x in xs]
        for q, s in qs:
            if not torch.equal(library_dequantize(q, s),
                               Q.dequantize_blocks_plain(q, s,
                                                         block=QUANT_BLOCK)):
                raise AssertionError(f"the torch.mul dequantize "
                                     f"{tuple(q.shape)} differs from plain")
        calls = {
            "quantize": lambda x, q, s: Q.quantize_blocks(x,
                                                          block=QUANT_BLOCK),
            "dequantize": lambda x, q, s: Q.dequantize_blocks(
                q, s, block=QUANT_BLOCK),
            "dequantize_library": lambda x, q, s: library_dequantize(q, s)}
        out = {}
        for key, call in calls.items():
            ms, hidden = device_ms(lambda: [call(x, q, s) for x, (q, s)
                                            in zip(xs, qs)], ATTN_REPS)
            if not hidden:
                raise AssertionError(f"{key}: the host outlasted the spin")
            out[f"{key}_ms"] = ms
        if keys is not None:
            out["per_leaf"] = []
            for key, x, (q, s) in zip(keys, xs, qs):
                leaf = dict(key=key, shape=list(x.shape), bound_ms=
                            quant_bound_ms(torch.float32, *x.shape)[0])
                for name, call in calls.items():
                    leaf[f"{name}_ms"] = device_ms(
                        lambda: call(x, q, s), ATTN_REPS)[0]
                    leaf[f"{name}_gbps"] = gbps(x, leaf[f"{name}_ms"])
                out["per_leaf"].append(leaf)
        out["quantize_plain_ms"] = cuda_ms(lambda: [Q.quantize_blocks_plain(
            x, block=QUANT_BLOCK) for x in xs], REPS)
        out["dequantize_plain_ms"] = cuda_ms(lambda: [
            Q.dequantize_blocks_plain(q, s, block=QUANT_BLOCK)
            for q, s in qs], REPS)
        bounds = [quant_bound_ms(torch.float32, *x.shape) for x in xs]
        out["bound_ms"] = sum(b for b, _ in bounds)
        out["bound_by"] = max(("bytes", "operations"), key=lambda k: sum(
            b for b, by in bounds if by == k))
        out["quantize_call_ms"] = cuda_ms(lambda: Q.quantize_blocks(
            xs[0], block=QUANT_BLOCK), REPS)
        out["dequantize_call_ms"] = cuda_ms(lambda: Q.dequantize_blocks(
            *qs[0], block=QUANT_BLOCK), REPS)
        return out

    big_key, big_shape, _ = max(leaves, key=lambda l: l[2])
    x = quant_input(dev, g, *big_shape, torch.float32)
    big = timed_pair([x])
    big["quantize_gbps"] = gbps(x, big["quantize_ms"])
    big["dequantize_gbps"] = gbps(x, big["dequantize_ms"])
    del x
    torch.cuda.empty_cache()
    step = timed_pair([quant_input(dev, g, *shape, torch.float32)
                       for _, shape, _ in leaves],
                      keys=[k for k, _, _ in leaves])
    torch.cuda.empty_cache()
    return dict(cases=cases, elements=elements, max_abs_err=0,
                leaves=len(leaves), leaf_shapes=[list(x) for x in shapes],
                extra_shapes=[list(x) for x in QUANT_EXTRA_SHAPES],
                launches_by_route=routes,
                largest_leaf=dict(key=big_key, shape=list(big_shape), **big),
                step=dict(launches_each=len(leaves), **step))


def plain_roundtrip(x, bits: int):
    """``approx_comm._quant_roundtrip`` through the plain quantize pair on
    any device: the yardstick the kernels' round trip is held to."""
    import torch
    from repro_torch.core.approx_comm import _pad_2d
    from repro_torch.kernels import quantize as Q
    x2d, n = _pad_2d(x, QUANT_BLOCK)
    q, s = Q.quantize_blocks_plain(x2d, block=QUANT_BLOCK, bits=bits)
    out = x.dtype if x.dtype in Q.KERNEL_DTYPES else torch.float32
    xd = Q.dequantize_blocks_plain(q, s, block=QUANT_BLOCK, out_dtype=out)
    return xd.reshape(-1)[:n].view(x.shape).to(x.dtype)


def plain_hook(bits: int):
    """The step's gradient hook (``make_grad_compressor(bits,
    min_size=GRAD_MIN_SIZE)``) through ``plain_roundtrip``."""
    from repro_torch.tree import tree_map

    def hook(grads):
        return tree_map(lambda g: plain_roundtrip(g, bits)
                        if g.numel() >= GRAD_MIN_SIZE else g, grads)
    return hook


def phase_train_check(dev, cfg) -> dict:
    """One full-width step's gradients (bfloat16 parameters, the config's
    microbatches, so float32 accumulated gradients), computed once; then
    the rest of the step twice, each from the same parameters and a fresh
    optimizer state: the hook through the kernels, then through the plain
    versions.  Raises unless the compressed gradients and every new
    parameter are bitwise identical."""
    import torch
    from repro_torch.core.approx_comm import make_grad_compressor
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch.steps import compute_grads, microbatch_count
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                         init_opt_state)
    from repro_torch.tree import tree_items, tree_map
    t0 = time.monotonic()
    model = build_model(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = model.init_params(g, device=dev)
    batch = make_batch(cfg, TRAIN_BATCH, CHECK_SEQ, generator=g, device=dev,
                       train=True)
    mb = microbatch_count(cfg, TRAIN_BATCH)
    loss, grads = compute_grads(model, params, batch, mb)
    torch.cuda.synchronize()
    grad_s = time.monotonic() - t0
    opt = AdamWConfig()
    n0 = (Q.quantize_blocks.launches, Q.dequantize_blocks.launches)
    r0 = route_counts()
    # the rest of build_train_step's step: the hook, then AdamW
    cg_k = make_grad_compressor(TRAIN_BITS, min_size=GRAD_MIN_SIZE)(grads)
    p_k, _ = adamw_update(opt, tree_map(torch.clone, params), cg_k,
                          init_opt_state(params, device=dev))
    torch.cuda.synchronize()
    launches = (Q.quantize_blocks.launches - n0[0],
                Q.dequantize_blocks.launches - n0[1])
    routes = route_delta(r0, route_counts())
    torch.cuda.empty_cache()
    cg_p = plain_hook(TRAIN_BITS)(grads)
    p_p, _ = adamw_update(opt, params, cg_p,
                          init_opt_state(params, device=dev))
    torch.cuda.synchronize()
    n_leaves = len(grad_leaves(cfg))
    diffs = [k for (k, a), (_, b) in zip(tree_items(cg_k), tree_items(cg_p))
             if not torch.equal(a, b)]
    pdiffs = [k for (k, a), (_, b) in zip(tree_items(p_k), tree_items(p_p))
              if not torch.equal(a, b)]
    out = dict(arch=cfg.name, batch=TRAIN_BATCH, seq=CHECK_SEQ,
               microbatches=mb, grad_dtype=str(
                   tree_items(grads)[0][1].dtype).removeprefix("torch."),
               loss=float(loss), grad_seconds=grad_s,
               seconds=time.monotonic() - t0, launches=list(launches),
               launches_by_route=routes,
               leaves=n_leaves, compressed_grads_identical=not diffs,
               params_identical=not pdiffs,
               finite=bool(all(torch.isfinite(v).all()
                               for _, v in tree_items(p_k))))
    del model, params, grads, p_k, p_p, cg_k, cg_p, batch
    torch.cuda.empty_cache()
    if diffs or pdiffs or launches != (n_leaves, n_leaves) \
            or routes != contiguous_only(n_leaves) or not out["finite"]:
        raise AssertionError(f"train_check failed: {out}; compressed "
                             f"grads differ at {diffs}, params at {pdiffs}")
    return out


def phase_train(dev) -> dict:
    """The timed training run through the port's entry point, with the
    quantize kernels' launches counted from zero just before it."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch.train import train
    cfg = get_config(TRAIN_ARCH)
    if TRAIN_REDUCED:
        cfg = cfg.reduced()
    n_leaves = len(grad_leaves(cfg))
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    Q.quantize_blocks.launches = Q.dequantize_blocks.launches = 0
    for f in (Q.quantize_blocks, Q.dequantize_blocks):
        f.launches_by_route = dict.fromkeys(Q.ROUTES, 0)
    t0 = time.monotonic()
    try:
        out = train(TRAIN_ARCH, reduced=TRAIN_REDUCED, steps=TRAIN_STEPS,
                    batch=TRAIN_BATCH, seq=TRAIN_SEQ, grad_bits=TRAIN_BITS,
                    checkpoint_every=TRAIN_CKPT_EVERY,
                    inject_failure_at=TRAIN_FAIL_AT,
                    checkpoint_dir=str(ckpt), log_every=1, device=dev)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    seconds = time.monotonic() - t0
    launches = {"quantize_blocks": Q.quantize_blocks.launches,
                "dequantize_blocks": Q.dequantize_blocks.launches}
    routes = route_delta({k: dict.fromkeys(Q.ROUTES, 0) for k in launches},
                         route_counts())
    steps_run = len(out["step_s"])
    step_s = np.asarray(out["step_s"])
    res = dict(arch=TRAIN_ARCH, reduced=TRAIN_REDUCED, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, grad_bits=TRAIN_BITS, seconds=seconds,
               steps_executed=steps_run, losses=out["losses"],
               step_p50_s=float(np.percentile(step_s, 50)),
               step_p95_s=float(np.percentile(step_s, 95)),
               step_s=out["step_s"],
               tokens_per_s=float(TRAIN_BATCH * TRAIN_SEQ * steps_run
                                  / step_s.sum()),
               checkpoint_s=out["checkpoint_s"],
               recoveries=out["recoveries"], launches=launches,
               launches_by_route=routes, launches_per_step=n_leaves,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9, device=out["device"])
    want_steps = TRAIN_FAIL_AT + TRAIN_STEPS - TRAIN_CKPT_EVERY
    if not np.isfinite(out["losses"]).all():
        raise AssertionError(f"non-finite loss: {out['losses']}")
    if out["recoveries"] != [(TRAIN_FAIL_AT, TRAIN_CKPT_EVERY)] \
            or steps_run != want_steps or len(out["losses"]) != want_steps:
        raise AssertionError(f"recovery: {out['recoveries']}, {steps_run} "
                             f"steps, want a replay from step "
                             f"{TRAIN_CKPT_EVERY} and {want_steps} steps")
    if launches != {k: n_leaves * want_steps for k in launches} \
            or routes != contiguous_only(n_leaves * want_steps):
        raise AssertionError(f"train launched {launches} ({routes} by "
                             f"route), want {n_leaves * want_steps} of each, "
                             f"all contiguous")
    return res


def phase_train_trace(dev) -> dict:
    """One full-width training step at the train phase's shape, traced
    with ``torch.profiler`` after one warm step: busy share, the top
    activities, and the quantize kernels' device time."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.approx_comm import make_grad_compressor
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    cfg = get_config(TRAIN_ARCH)
    if TRAIN_REDUCED:
        cfg = cfg.reduced()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = build_model(cfg).init_params(g, device=dev)
    state = init_opt_state(params, device=dev)
    batch = make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, generator=g, device=dev,
                       train=True)
    step = build_train_step(cfg, AdamWConfig(), make_grad_compressor(
        TRAIN_BITS, min_size=GRAD_MIN_SIZE))
    box = {"p": params, "s": state}

    def one():
        box["p"], box["s"], _ = step(box["p"], box["s"], batch)

    one()
    torch.cuda.synchronize()
    tr = traced(one, 16, kernels=("quantize_cluster", "dequantize_stream"))
    total = tr["device_ms_total"]
    tr["kernel_share_of_device_ms"] = {
        k: v["ms"] / total if total else None
        for k, v in tr["kernel_ms"].items()}
    del box, params, state, batch
    torch.cuda.empty_cache()
    return dict(arch=TRAIN_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                step_ms_traced=tr.pop("ms_traced"), **tr)


def phase_collective(dev, cfg) -> dict:
    """``compressed_mean`` on a one-rank NCCL group over a tensor of the
    largest gradient leaf's shape: bitwise the plain round trip at bits 8
    and 4, the exact mean at 16, with its time; then the
    ``CollectiveController`` against a host ``LatencyController`` over the
    contention sequence of ``tests/test_runtime.py``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import approx_comm as AC
    from repro_torch.core.characterization import LatencyRegression
    from repro_torch.core.controller import (ControllerConfig,
                                             LatencyController)
    from repro_torch.models.transformer import param_shapes
    from repro_torch.tree import tree_items
    key, shape = max(tree_items(param_shapes(cfg)),
                     key=lambda kv: torch.Size(kv[1]).numel())
    store_path = ROOT / "build" / "chip_smoke_store"
    store_path.parent.mkdir(parents=True, exist_ok=True)
    store_path.unlink(missing_ok=True)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = torch.randn(shape, generator=g, device=dev) * 1e-3
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(str(store_path), 1),
                            rank=0, world_size=1)
    out = dict(leaf=key, shape=list(shape), backend=backend)
    r0 = route_counts()
    try:
        for bits in (8, 4):
            got = AC.compressed_mean(x, bits)
            want = plain_roundtrip(x, bits)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"compressed_mean bits {bits} differs "
                                     f"from the plain round trip")
            out[f"bits{bits}_ms"] = cuda_ms(
                lambda: AC.compressed_mean(x, bits), REPS)
            del got, want
        exact = AC.compressed_mean(x, 16)
        torch.cuda.synchronize()
        if not torch.equal(exact, x):
            raise AssertionError("compressed_mean at 16 bits is not the "
                                 "exact mean")
        out["bits16_ms"] = cuda_ms(lambda: AC.compressed_mean(x, 16), REPS)
    finally:
        dist.destroy_process_group()
        store_path.unlink(missing_ok=True)
    del x
    routes = out["launches_by_route"] = route_delta(r0, route_counts())
    if set(routes) != {"quantize_blocks", "dequantize_blocks"} \
            or any(set(v) != {"contiguous"} for v in routes.values()):
        raise AssertionError(f"compressed_mean launched {routes} by route, "
                             f"want every launch contiguous")
    grad_bytes, fidelity, bw = 4e6, {16: 1.0, 8: 0.999, 4: 0.985}, 3e9
    target = 1.5 * grad_bytes / bw
    ctl = AC.CollectiveController(grad_bytes, fidelity,
                                  latency_target=target, fidelity_floor=0.98,
                                  slope=1.0 / bw, device=dev)
    host = LatencyController(
        ControllerConfig(target, 0.98, error_threshold=0.05 * target),
        AC.fidelity_table(grad_bytes, fidelity),
        LatencyRegression(slope=1.0 / bw, intercept=1e-4))
    bits, used = 16, []
    t0 = time.monotonic()
    for step in range(COLLECTIVE_STEPS):
        contention = 8.0 if 20 <= step < 40 else 1.0
        lat = AC.collective_bytes_for(grad_bytes, bits) / (
            bw / contention) + 1e-4
        d, dh = ctl.update(lat), host.update(lat)
        if (d.setting_index, d.acted, d.feasible) != (
                dh.setting_index, dh.acted, dh.feasible):
            raise AssertionError(f"controller step {step}: device {d} vs "
                                 f"host {dh}")
        bits = d.bits
        used.append(bits)
    out["controller"] = dict(steps=COLLECTIVE_STEPS, identical_to_host=True,
                             ms_per_update=(time.monotonic() - t0) * 1e3
                             / COLLECTIVE_STEPS,
                             bits_used=sorted(set(used)),
                             min_bits_under_contention=min(used[20:40]),
                             final_bits=used[-1])
    if not (min(used[20:40]) < 16 and used[-1] == 16):
        raise AssertionError(f"the controller did not compress under "
                             f"contention and relax after: {used}")
    return out


def phase_training(dev) -> tuple[dict, dict]:
    """The training phases in order; returns (quant_kernels result, train
    result) and emits one line per phase."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    if TRAIN_REDUCED:
        cfg = cfg.reduced()
    t0 = time.monotonic()
    quant = phase_quant_kernels(dev, cfg)
    emit("quant_kernels", seconds=time.monotonic() - t0, **quant)
    emit("train_check", **phase_train_check(dev, cfg))
    run = phase_train(dev)
    emit("train", **run)
    t0 = time.monotonic()
    trace = phase_train_trace(dev)
    emit("train_trace", seconds=time.monotonic() - t0, **trace)
    t0 = time.monotonic()
    coll = phase_collective(dev, cfg)
    emit("collective", seconds=time.monotonic() - t0, **coll)
    torch.cuda.empty_cache()
    return quant, run


def quant_kernel_rows(quant: dict, run: dict,
                      families: "dict | None" = None) -> list[dict]:
    """The ``kernels`` line's rows of the quantize pair: launches from the
    timed training run (and, by path, from each family's steps in
    ``families``); device ms, plain ms and the bound of the step's 13
    launches each (float32, bits 8), the largest leaf's beside them."""
    big, step = quant["largest_leaf"], quant["step"]
    rows = []
    for name, src_line in (("quantize_blocks", 44), ("dequantize_blocks", 70)):
        key = name.split("_")[0]
        lib = step.get(f"{key}_library_ms")
        rows.append({
            "name": name, "route": "cuda", "kernel_route": "contiguous",
            "source": "src/repro_torch/kernels/csrc/quantize_blocks.cu",
            "replaces": f"src/repro/kernels/quantize.py:{src_line}",
            "launches": run["launches"][name],
            "launches_by_route": run["launches_by_route"][name],
            "launches_by_path": {
                TRAIN_ARCH: run["launches"][name],
                **{a: f["launches"][name]
                   for a, f in (families or {}).items()}},
            "max_abs_err": quant["max_abs_err"],
            "ms": step[f"{key}_ms"], "plain_ms": step[f"{key}_plain_ms"],
            "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
            "library_ms": lib,
            "call_ms": big[f"{key}_call_ms"],
            "largest_leaf_ms": big[f"{key}_ms"],
            "largest_leaf_library_ms": big.get(f"{key}_library_ms"),
            "largest_leaf_plain_ms": big[f"{key}_plain_ms"],
            "largest_leaf_bound_ms": big["bound_ms"],
            "shape": f"the step's {step['launches_each']} launches on "
                     f"float32 [rows, 512] gradients, bits 8; largest "
                     f"leaf {big['key']} {big['shape']}"})
    return rows


def distinct_bytes(*tensors) -> int:
    """Bytes of device memory that ``tensors`` span together: overlapping
    views (the path's ``gray[1:]`` and ``gray[:-1]``) count once."""
    spans = sorted((t.data_ptr(), t.data_ptr() + t.nbytes) for t in tensors)
    total, end = 0, 0
    for lo, hi in spans:
        total += max(0, hi - max(lo, end))
        end = max(end, hi)
    return total


def knobs_bound_ms(f, p, k: int) -> tuple[float, str]:
    """Least time of one ``frame_knobs`` call on the card: the memory that
    frames and prev span read once (planes they share count once), the
    float32 output and ``changed`` written once, over the memory rate,
    against the float32 operations (a subtract, an absolute value and a
    compare per input pixel, four per pooled value, k adds and a multiply
    per pass of the blur) over the float32 rate."""
    n, h, w = f.shape
    pooled = n * (h // 2) * (w // 2)
    nbytes = distinct_bytes(f, p) + 4 * pooled + 4 * n
    flops = 3 * n * h * w + 4 * pooled + (2 * (k + 1) * pooled if k > 1
                                          else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def knobs_inputs(dev, g, n: int, dtype):
    """[n, H, W] frames and prev: uniform grey levels, prev the frames
    moved by up to +-16 levels (so about half of the pixels change by more
    than the threshold of 8); float32 adds a uniform fraction to both, so
    no sum of the kernel is exact and its order shows."""
    import torch
    shape = (n, H, W)
    f = torch.randint(0, 256, shape, generator=g, device=dev,
                      dtype=torch.int16)
    p = (f + torch.randint(-16, 17, shape, generator=g, device=dev,
                           dtype=torch.int16)).clamp_(0, 255)
    if dtype == torch.uint8:
        return f.to(torch.uint8), p.to(torch.uint8)
    return (f.float() + torch.rand(shape, generator=g, device=dev),
            p.float() + torch.rand(shape, generator=g, device=dev))


def knobs_check(f, p, k: int, what: str):
    """The kernel against ``frame_knobs_plain`` on (f, p); raises unless
    ``out`` and ``changed`` are bitwise equal and, where the wrapper counts
    launches per route, the call took the route ``knobs_route`` names.
    Returns the kernel's."""
    import torch
    from repro_torch.kernels import frame_knobs as FK
    by_route = getattr(FK.frame_knobs, "launches_by_route", None)
    before = dict(by_route) if by_route is not None else None
    out, ch = FK.frame_knobs(f, p, blur_k=k)
    if before is not None:
        want = FK.knobs_route(f, p)
        got = {r: n - before[r] for r, n in by_route.items() if n != before[r]}
        if got != {want: 1}:
            raise AssertionError(f"frame_knobs {what}: launches by route "
                                 f"{got}, want {{{want!r}: 1}}")
    want_out, want_ch = FK.frame_knobs_plain(f, p, blur_k=k)
    torch.cuda.synchronize()
    if not (torch.equal(out, want_out) and torch.equal(ch, want_ch)):
        raise AssertionError(
            f"frame_knobs {what} blur_k {k}: differs from plain (max |d| "
            f"out {float((out - want_out).abs().max())}, changed "
            f"{float((ch - want_ch).abs().max())})")
    return out, ch


def phase_frame_knobs_kernel(dev) -> dict:
    """The knob kernel against its plain version at 1080x1920: N=25 in
    uint8 and float32 at every blur width of ``KNOBS_BLURS``, identical
    frames (``changed`` 0) and N=1, then the camera path's case -- a
    26-plane float32 window as ``g[1:]`` and ``g[:-1]`` at blur
    ``KNOBS_BLUR``; each (dtype, blur) and the window timed behind the spin
    kernel beside the plain version (CUDA events per call) and the
    bound."""
    import torch
    from repro_torch.kernels import frame_knobs as FK
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows, cases = [], 0
    for dtype in (torch.uint8, torch.float32):
        name = str(dtype).removeprefix("torch.")
        f, p = knobs_inputs(dev, g, KNOBS_N, dtype)
        for k in KNOBS_BLURS:
            _, ch = knobs_check(f, p, k, f"{name} N={KNOBS_N}")
            if not bool(((ch > 0.3) & (ch < 0.7)).all()):
                raise AssertionError(f"frame_knobs {name}: changed "
                                     f"{ch.tolist()} outside (0.3, 0.7)")
            cases += 1
            ms, hidden = device_ms(
                lambda k=k: FK.frame_knobs(f, p, blur_k=k), ATTN_REPS)
            if not hidden:
                raise AssertionError("frame_knobs: the host outlasted the "
                                     "spin")
            bound, by = knobs_bound_ms(f, p, k)
            rows.append(dict(
                dtype=name, case="independent", blur_k=k, ms=ms,
                bound_ms=bound, bound_by=by,
                plain_ms=cuda_ms(lambda k=k: FK.frame_knobs_plain(
                    f, p, blur_k=k), REPS)))
        _, ch = knobs_check(f, f, KNOBS_BLUR, f"{name} identical frames")
        if bool(ch.any()):
            raise AssertionError(f"frame_knobs {name}: identical frames "
                                 f"changed {ch.tolist()}")
        knobs_check(f[:1].contiguous(), p[:1].contiguous(), KNOBS_BLUR,
                    f"{name} N=1")
        cases += 2
        del f, p
        torch.cuda.empty_cache()
    gray = knobs_inputs(dev, g, KNOBS_N + 1, torch.float32)[0]
    g1, g0 = gray[1:], gray[:-1]
    knobs_check(g1, g0, KNOBS_BLUR, "float32 window")
    cases += 1
    ms, hidden = device_ms(lambda: FK.frame_knobs(g1, g0, blur_k=KNOBS_BLUR),
                           ATTN_REPS)
    if not hidden:
        raise AssertionError("frame_knobs: the host outlasted the spin")
    bound, by = knobs_bound_ms(g1, g0, KNOBS_BLUR)
    rows.append(dict(dtype="float32", case="window", blur_k=KNOBS_BLUR,
                     ms=ms, bound_ms=bound, bound_by=by,
                     plain_ms=cuda_ms(lambda: FK.frame_knobs_plain(
                         g1, g0, blur_k=KNOBS_BLUR), REPS)))
    del gray, g1, g0
    torch.cuda.empty_cache()
    return dict(cases=cases, shape=[KNOBS_N, H, W], max_abs_err=0.0,
                timings=rows)


def phase_camera_node(dev) -> dict:
    """The camera node's device path at the paper's testbed size: five
    1080p cameras append into their device rings (half of the appends from
    host frames, half from frames already on the card, then one out of
    order each), point and range queries read them back bit for bit, and
    each camera's subscriber window goes through ``ops.frame_knobs`` as
    gray planes.  ``frame_knobs.launches`` counts that path alone."""
    import numpy as np
    import torch
    from repro_torch.configs.mez_edge import CONFIG
    from repro_torch.core.log import (frame_log_append, frame_log_init,
                                      frame_log_point_query,
                                      frame_log_range_query)
    from repro_torch.data.camera import CameraConfig, SyntheticCamera
    from repro_torch.kernels import frame_knobs as FK
    from repro_torch.kernels import ops
    fps = CONFIG.fps
    cam_ids = [f"cam{i}" for i in range(N_CAMS)]
    from concurrent.futures import ThreadPoolExecutor

    def frames_of(cid):
        src = SyntheticCamera(CameraConfig(
            camera_id=cid, height=H, width=W, dynamics="complex", fps=fps,
            seed=CONFIG.seed))
        return [src.next_frame()[1] for _ in range(CAM_DISTINCT)]

    # each camera draws from its own generator: one thread a camera (NumPy
    # drops the GIL in its array work)
    t0 = time.monotonic()
    with ThreadPoolExecutor(N_CAMS) as pool:
        host = dict(zip(cam_ids, pool.map(frames_of, cam_ids)))
    gen_s = time.monotonic() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    on_card = {cid: torch.from_numpy(np.stack(fr)).to(dev)
               for cid, fr in host.items()}

    # -- the path: counts from 0, read just after ---------------------------
    FK.frame_knobs.launches = 0
    FK.frame_knobs.launches_by_route = dict.fromkeys(FK.KNOBS_ROUTES, 0)
    t_path = time.monotonic()
    logs = {cid: frame_log_init(CAM_CAPACITY, (H, W, 3), device=dev)
            for cid in cam_ids}
    half = CAM_APPENDS // 2
    append_us = {}
    for key, lo, hi, src in (("host", 0, half, host),
                             ("device", half, CAM_APPENDS, on_card)):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for i in range(lo, hi):
            for cid in cam_ids:
                frame_log_append(logs[cid], i / fps,
                                 src[cid][i % CAM_DISTINCT])
        torch.cuda.synchronize()
        append_us[key] = (time.monotonic() - t0) / ((hi - lo) * N_CAMS) * 1e6
    oldest = CAM_APPENDS - CAM_CAPACITY          # the oldest live index
    for cid in cam_ids:                          # out of order: refused
        frame_log_append(logs[cid], oldest / fps, on_card[cid][0])
    t_start, t_stop = (CAM_APPENDS - CAM_WINDOW) / fps, (CAM_APPENDS - 1) / fps
    windows = {cid: frame_log_range_query(logs[cid], t_start, t_stop,
                                          CAM_WINDOW) for cid in cam_ids}
    results = {}
    for cid in cam_ids:
        gray = windows[cid][2].float().mean(-1)          # [26, H, W] f32
        results[cid] = (gray, ops.frame_knobs(gray[1:], gray[:-1],
                                              blur_k=KNOBS_BLUR))
    torch.cuda.synchronize()
    path_s = time.monotonic() - t_path
    launches = FK.frame_knobs.launches
    by_route = dict(FK.frame_knobs.launches_by_route)
    if launches != N_CAMS or by_route["vector"] != N_CAMS:
        raise AssertionError(f"the camera path launched frame_knobs "
                             f"{launches} times ({by_route}), want "
                             f"{N_CAMS}, all on the vector route")

    # -- what came out --------------------------------------------------------
    f32 = np.float32
    for cid in cam_ids:
        log = logs[cid]
        state = (int(log.count), int(log.head), int(log.rejects),
                 float(log.last_ts))
        want = (CAM_CAPACITY, CAM_APPENDS % CAM_CAPACITY, 1,
                float(f32((CAM_APPENDS - 1) / fps)))
        if state != want:
            raise AssertionError(f"{cid}: (count, head, rejects, last_ts) "
                                 f"{state}, want {want}")
        # at the oldest live entry, between two, at the newest, after it,
        # and before the oldest (a miss: its slot was overwritten)
        probes = ((oldest / fps, oldest), ((oldest + 37.5) / fps, oldest + 37),
                  ((CAM_APPENDS - 1) / fps, CAM_APPENDS - 1),
                  (1e9, CAM_APPENDS - 1), ((oldest - 0.5) / fps, None))
        for q, i in probes:
            found, ts, frame = frame_log_point_query(log, q)
            if i is None:
                if bool(found) or float(ts) != -np.inf:
                    raise AssertionError(f"{cid}: a query before the oldest "
                                         f"live entry found {float(ts)}")
                continue
            if not (bool(found) and float(ts) == float(f32(i / fps))
                    and torch.equal(frame, on_card[cid][i % CAM_DISTINCT])):
                raise AssertionError(f"{cid}: point query {q} did not "
                                     f"return entry {i}")
        valid, ts, frames = windows[cid]
        idx = range(CAM_APPENDS - CAM_WINDOW, CAM_APPENDS)
        if not (bool(valid.all()) and ts.tolist() == [
                float(f32(i / fps)) for i in idx] and all(
                torch.equal(frames[j], on_card[cid][i % CAM_DISTINCT])
                for j, i in enumerate(idx))):
            raise AssertionError(f"{cid}: the range query's window differs "
                                 f"from the frames appended")
        gray, (out, ch) = results[cid]
        want_out, want_ch = FK.frame_knobs_plain(gray[1:], gray[:-1],
                                                 blur_k=KNOBS_BLUR)
        if not (torch.equal(out, want_out) and torch.equal(ch, want_ch)):
            raise AssertionError(f"{cid}: frame_knobs differs from plain")
        if out.shape != (KNOBS_N, H // 2, W // 2) or not bool(
                torch.isfinite(out).all()) or not bool(
                ((ch >= 0) & (ch <= 1)).all()):
            raise AssertionError(f"{cid}: frame_knobs out of its contract")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ring_gb = sum(log.payload.nbytes for log in logs.values()) / 1e9

    # -- timed apart from the path ------------------------------------------
    log0 = logs[cam_ids[0]]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for r in range(QUERY_REPS):
        frame_log_point_query(log0, (oldest + r) / fps)
    torch.cuda.synchronize()
    point_us = (time.monotonic() - t0) / QUERY_REPS * 1e6
    range_ms = cuda_ms(lambda: frame_log_range_query(
        log0, t_start, t_stop, CAM_WINDOW), REPS)
    gray = results[cam_ids[0]][0]
    g1, g0 = gray[1:], gray[:-1]
    ms, hidden = device_ms(lambda: ops.frame_knobs(g1, g0,
                                                   blur_k=KNOBS_BLUR),
                           ATTN_REPS)
    if not hidden:
        raise AssertionError("frame_knobs: the host outlasted the spin")
    plain_ms = cuda_ms(lambda: FK.frame_knobs_plain(g1, g0,
                                                    blur_k=KNOBS_BLUR), REPS)
    # gray[1:] and gray[:-1] share 24 of their 25 planes: 26 planes to read
    bound, by = knobs_bound_ms(g1, g0, KNOBS_BLUR)
    changed = [round(float(c), 6) for c in results[cam_ids[0]][1][1][:4]]
    del logs, windows, results, on_card, gray, g1, g0, log0
    torch.cuda.empty_cache()
    return dict(
        cameras=N_CAMS, capacity=CAM_CAPACITY, appends=CAM_APPENDS,
        frame=[H, W, 3], ring_gb=ring_gb, peak_gb=peak_gb,
        generate_seconds=gen_s, path_seconds=path_s,
        append_us_from_host=append_us["host"],
        append_us_from_device=append_us["device"],
        point_query_us=point_us, range_query_ms=range_ms,
        window=CAM_WINDOW, launches=launches, launches_by_route=by_route,
        ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, changed_cam0=changed)



def synthetic_table(n: int = 24, smin: float = 2e3, smax: float = 9e4):
    """benchmarks/common.py's ``synthetic_controller_table`` (the JAX
    suite's table for the fig11 and tenant-flood goldens), built in the
    port: a monotone size->accuracy table with no sweep behind it."""
    import numpy as np
    from repro_torch.core.characterization import CharacterizationTable
    from repro_torch.core.knobs import KnobSetting
    sizes = np.linspace(smin, smax, n)
    accs = 0.90 + 0.10 * (sizes - smin) / (smax - smin)
    return CharacterizationTable(
        settings=tuple(KnobSetting(resolution=i % 5) for i in range(n)),
        sizes_sorted=sizes, best_acc=accs, best_idx=np.arange(n),
        acc_by_setting=accs, size_by_setting=sizes)


def scenario_specs(S) -> dict:
    """The scripted runs of the scenario phase, over the port's scenario
    module ``S``: tests/test_scenario.py's paper claim and its two golden
    specs, tests/test_drift.py's sceneshift golden, and
    benchmarks/gauntlet.py's federated phase (2 brokers, 8 SLO tenants,
    two live migrations, a degraded backhaul, a rolling upgrade), here on
    the fleet tick."""
    cams = lambda n, dyn: tuple(S.CameraSpec(f"cam{i}", dynamics=dyn)
                                for i in range(n))

    def claim(**kw):
        return S.ScenarioSpec(
            name="paper-claim-10x", cameras=cams(5, "complex"), frames=60,
            seed=3, workload="jaad", latency=0.100, accuracy=0.95,
            min_accuracy=0.95,
            events=(S.InterferenceSpike(start=4.0, end=9.0, factor=10.0),),
            **kw)

    t_end = FED_FRAMES / 5.0
    slo = ("best_effort", "silver", "gold")
    fed_events = [S.TenantJoin(at=round(0.2 + 0.1 * i, 3), tenant=f"f{i}",
                               slo=slo[i % 3]) for i in range(8)] + [
        S.CameraMigrate(at=round(t_end * 0.25, 3), camera_id="cam0",
                        to_broker=1),
        S.CameraMigrate(at=round(t_end * 0.35, 3), camera_id="cam3",
                        to_broker=0),
        S.BrokerOverload(at=round(t_end * 0.5, 3), broker=0, factor=0.5),
        S.RollingUpgrade(at=round(t_end * 0.7, 3))]
    return {
        "claim": claim(fleet=True, record_decisions=True),
        "claim_uncontrolled": claim(controlled=False),
        "scenario_fig11_small": S.ScenarioSpec(
            name="golden-fig11-small", cameras=cams(3, "complex"),
            frames=24, seed=11, workload="jaad", latency=0.100,
            accuracy=0.92,
            events=(S.InterferenceSpike(start=2.0, end=3.5, factor=6.0),
                    S.QosChange(at=4.0, latency=0.060))),
        "scenario_tenant_flood": S.ScenarioSpec(
            name="tenant-flood", cameras=cams(2, "medium"), frames=20,
            seed=5, workload="jaad", latency=0.100, accuracy=0.92,
            wire_budget=1.65e7,
            events=(S.TenantJoin(at=0.5, tenant="acme", slo="gold"),
                    S.TenantJoin(at=1.0, tenant="bulk", slo="best_effort"),
                    S.TenantJoin(at=1.5, tenant="probe", slo="gold",
                                 admission="reject"),
                    S.TenantLeave(at=3.0, tenant="acme"))),
        "scenario_sceneshift_refresh": S.ScenarioSpec(
            name="golden-sceneshift-refresh", cameras=cams(2, "simple"),
            frames=30, seed=17, workload="jaad", latency=0.100,
            accuracy=0.95, min_accuracy=0.90, auto_recharacterize=True,
            events=(S.SceneShift(at=2.0, camera_id="cam1",
                                 dynamics="complex"),)),
        "federated": S.ScenarioSpec(
            name="gauntlet-federated",
            cameras=tuple(S.CameraSpec(f"cam{i}", dynamics="medium",
                                       fps=5.0) for i in range(4)),
            frames=FED_FRAMES, seed=11, workload="jaad", latency=0.100,
            accuracy=0.92, n_brokers=2, fleet=True,
            events=tuple(sorted(fed_events, key=lambda e: e.at))),
    }


class PollMeter:
    """Counts ``Subscription.poll`` calls (the main stream's and every
    tenant's) and times each fused fleet tick with the host clock ending
    in ``torch.cuda.synchronize()``, while active; each timed tick is a
    ``TICK_LABEL`` range in a profiler trace (``tick_split``)."""

    def __init__(self):
        self.polls, self.tick_ms = 0, []

    def __enter__(self):
        import torch
        from repro_torch.core.controller import FleetController
        from repro_torch.core.session import Subscription
        self._saved = [(Subscription, "poll", Subscription.poll),
                       (FleetController, "tick", FleetController.tick)]
        poll, tick, meter = Subscription.poll, FleetController.tick, self

        def counted_poll(sub, *a, **kw):
            meter.polls += 1
            return poll(sub, *a, **kw)

        def timed_tick(fleet, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function(TICK_LABEL):
                out = tick(fleet, *a, **kw)
                torch.cuda.synchronize()
            meter.tick_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        Subscription.poll, FleetController.tick = counted_poll, timed_tick
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)


def first_difference(got: str, want: str) -> str:
    """The first differing trace row (or top-level field) of two scenario
    JSON traces."""
    g, w = json.loads(got), json.loads(want)
    for i, (a, b) in enumerate(zip(g["rows"], w["rows"])):
        if a != b:
            return f"row {i}: card {a} vs golden {b}"
    if len(g["rows"]) != len(w["rows"]):
        return f"{len(g['rows'])} rows vs {len(w['rows'])}"
    keys = sorted(k for k in set(g) | set(w) if g.get(k) != w.get(k))
    return f"fields {keys}"


def exactly_once(res, frames: int) -> None:
    """Every camera of a scenario delivered each of its ``frames`` frames
    once, in order."""
    for cid in res.camera_ids:
        got = [r.timestamp for r in res.rows if r.camera_id == cid]
        if got != sorted(set(got)) or len(got) != frames:
            raise AssertionError(f"{cid}: delivered {len(got)} of {frames} "
                                 f"frames ({len(set(got))} distinct)")


class GridRecorder:
    """Keeps the inputs and a copy of the outputs of every
    ``frame_knob_grid`` kernel launch while active.  It wraps the wrapper's
    launch step (``frame_knobs._launch``, the one place that counts a
    launch), so each recorded call is one counted launch."""

    def __enter__(self):
        from repro_torch.kernels import frame_knobs as FK
        self.calls, self._fk, launch = [], FK, FK._launch

        def recorded(*args):
            out = launch(*args)
            self.calls.append((args, tuple(t.clone() for t in out)))
            return out

        self._launch, FK._launch = launch, recorded
        return self

    def __exit__(self, *exc):
        self._fk._launch = self._launch


def scenario_kernel_check(dev, calls, launches: int) -> dict:
    """Every ``frame_knob_grid`` launch of the scenario path (``calls``,
    from ``GridRecorder``), at the path's own inputs: the outputs the path
    got, bitwise against the plain version run on the CPU (``compare``
    with no payload byte off: ``changed`` equal, proxy features within
    ``FEAT_RTOL`` of the plain version's and equal to those of the
    payload); each call repeated bit for bit.  The plain version on the
    card is no oracle at 144x256: its dense products sum in another order
    there and its ``changed`` divides through a reciprocal
    (tests/test_torch_frame_knobs.py).  Then the path's calls timed
    together: device ms behind the spin, the plain version on the card,
    the bound."""
    import torch
    from repro_torch.kernels import frame_knobs as FK
    if len(calls) != launches:
        raise AssertionError(f"recorded {len(calls)} frame_knob_grid "
                             f"launches, the path counted {launches}")
    host = lambda t: None if t is None else t.cpu()
    shapes, replays, worst = {}, [], (0, 0.0)
    bound = {"bytes": 0.0, "operations": 0.0}
    for (frames, prev, plan, bg, en, pd, at), got in calls:
        kw = dict(background=bg, art_enable=en, pixel_delta=pd,
                  art_thresh=at)
        again = FK.frame_knob_grid(frames, prev, plan, device=dev, **kw)
        if not all(torch.equal(a, b) for a, b in zip(again, got)):
            raise AssertionError("frame_knob_grid repeated a scenario call "
                                 "with other outputs")
        cpu = FK.frame_knob_grid_plain(
            host(frames), host(prev), plan, background=host(bg),
            art_enable=host(en), pixel_delta=pd, art_thresh=at)
        off = compare(got, tuple(t.to(dev) for t in cpu))
        if off != (0, 0.0):
            raise AssertionError(f"frame_knob_grid at {frames.shape[0]} "
                                 f"frames, scale {plan.scale}: payload off "
                                 f"the CPU's plain version by {off}")
        worst = max(worst, off)
        b_ms, b_by = bound_ms(plan, frames.shape[0], bg is not None)
        bound[b_by] += b_ms
        key = (f"{plan.in_h}x{plan.in_w} F={frames.shape[0]} "
               f"knob4={'on' if bg is not None else 'off'}")
        shapes[key] = shapes.get(key, 0) + 1
        replays.append((frames, prev, plan, kw))
        del again, cpu
    torch.cuda.synchronize()
    ms, hidden = device_ms(lambda: [FK.frame_knob_grid(
        f, p, pl, device=dev, **kw) for f, p, pl, kw in replays], 1)
    plain = cuda_ms(lambda: [FK.frame_knob_grid_plain(f, p, pl, **kw)
                             for f, p, pl, kw in replays], 1)
    return dict(calls=len(calls), shapes=shapes, bitwise_vs_cpu_plain=True,
                max_abs_err=worst[0], mismatch_fraction=worst[1], ms=ms,
                hidden=hidden, plain_ms=plain,
                bound_ms=sum(bound.values()),
                bound_by=max(bound, key=bound.get))


def two_medium_cameras(system) -> dict:
    """cam0 and cam1 on ``system``: medium synthetic cameras (seed 7) with
    their backgrounds, under (100 ms, 0.90) on ``synthetic_table`` and a
    latency fit over 12 of its sizes; returns their sources by id."""
    import numpy as np
    from repro_torch.core.characterization import fit_latency_regression
    from repro_torch.data.camera import CameraConfig, SyntheticCamera
    tbl = synthetic_table()
    sizes = np.linspace(tbl.sizes_sorted[0], tbl.sizes_sorted[-1], 12)
    reg = fit_latency_regression(
        sizes, system.channel.regression_points(sizes, n=2))
    srcs = {}
    for cid in ("cam0", "cam1"):
        cam = system.add_camera(cid)
        srcs[cid] = SyntheticCamera(CameraConfig(camera_id=cid,
                                                 dynamics="medium", seed=7))
        cam.background = srcs[cid].background
        cam.set_target(0.100, 0.90, tbl, reg)
    return srcs


def phase_scenario(dev) -> dict:
    """The scripted-experiment path on ``dev`` (``scenario_runs``), then
    every ``frame_knob_grid`` launch it made held against the plain version
    (``scenario_kernel_check``).  Raises on any failure."""
    with GridRecorder() as rec:
        out = scenario_runs(dev)
    out["kernel"] = scenario_kernel_check(dev, rec.calls, out["launches"])
    return out


def scenario_runs(dev) -> dict:
    """Characterize, the paper claim, the three goldens, a federated herd,
    and MQTT ingress on ``dev`` (see the module docstring).  Raises on any
    failure."""
    import numpy as np
    import torch
    from repro_torch.configs.mez_edge import CONFIG
    from repro_torch.core import scenario as S
    from repro_torch.core.api import QosBounds
    from repro_torch.core.broker import MezSystem
    from repro_torch.core.channel import calibrated_channel
    from repro_torch.core.characterization import characterize
    from repro_torch.core.federation import FederatedMezSystem
    from repro_torch.core.mqtt_bridge import MqttBridge, topic_for
    from repro_torch.core.session import MezClient
    from repro_torch.data.camera import CameraConfig, SyntheticCamera
    from repro_torch.kernels import frame_knobs as FK

    specs = scenario_specs(S)
    out: dict = {"frame": [CONFIG.frame_height, CONFIG.frame_width],
                 "fps": CONFIG.fps, "runs": {}}

    def run(name, tables, *, trace=False):
        """One scenario on ``dev``: (result, each fleet tick's ms, the
        ``traced`` record or None); records its wall seconds (ending in a
        synchronise), polls, frames and ticks under ``out["runs"]``."""
        res = []
        with PollMeter() as meter:
            t0 = time.monotonic()
            if trace:
                tr = traced(lambda: res.append(S.run_scenario(
                    specs[name], tables=tables, device=dev)), 4, FKG_NAMES,
                    split=True)
            else:
                res.append(S.run_scenario(specs[name], tables=tables,
                                          device=dev))
                torch.cuda.synchronize()
                tr = None
            wall = time.monotonic() - t0
        for label, size in (("fleet tick", res[0].fleet_cache_size),
                            ("drift monitor", res[0].drift_cache_size)):
            if size is not None and size != 1:
                raise AssertionError(f"{name}: the {label} ran on {size} "
                                     f"table layouts, want 1")
        out["runs"][name] = {"seconds": wall, "polls": meter.polls,
                             "frames": len(res[0].rows),
                             "fleet_ticks": len(meter.tick_ms)}
        return res[0], meter.tick_ms, tr

    # -- characterize: the claim's table, through the kernel ---------------
    clip = lambda: SyntheticCamera(CameraConfig(dynamics="complex", seed=7))
    FK.frame_knob_grid.launches = 0
    holder = []
    tr = traced(lambda: holder.append(characterize(
        clip, clip_len=SCEN_CLAIM_CLIP, min_accuracy=0.95, device=dev)),
        4, FKG_NAMES)
    table = holder[0]
    char_launches = FK.frame_knob_grid.launches
    if not char_launches:
        raise AssertionError("characterize never launched frame_knob_grid")
    cpu_table = characterize(clip, clip_len=SCEN_CLAIM_CLIP,
                             min_accuracy=0.95, device="cpu")
    if (table.settings != cpu_table.settings
            or not np.array_equal(table.acc_by_setting,
                                  cpu_table.acc_by_setting)
            or not np.array_equal(table.best_idx, cpu_table.best_idx)):
        raise AssertionError("the card's characterize kept other settings, "
                             "accuracies or best settings than the CPU's")
    rel_size = float(np.max(np.abs(
        table.size_by_setting / cpu_table.size_by_setting - 1)))
    if not rel_size <= SIZE_RTOL:
        raise AssertionError(f"the card's characterize sizes are off the "
                             f"CPU's by {rel_size} relative")
    out["characterize"] = {
        "seconds": tr["ms_traced"] / 1e3, "kept": len(table.settings),
        "launches": char_launches,
        "kernel_device_ms": sum(v["ms"] for v in tr["kernel_ms"].values()),
        "device_busy_share": tr["device_busy_share"],
        "max_rel_size_vs_cpu": rel_size}

    # -- the paper claim: 10x spike, fleet tick once per poll --------------
    tables = {"complex": table}
    ctl, tick_ms, _ = run("claim", tables)
    again, _, tr = run("claim", tables, trace=True)
    if again.to_json() != ctl.to_json():
        raise AssertionError("two claim runs on the card differ")
    unc, _, _ = run("claim_uncontrolled", tables)
    unc_spike = unc.p95_latency_ms(5.0, 9.0)
    base_acc = ctl.mean_accuracy(2.0, 4.0)
    claim = {
        "uncontrolled_spike_over_base": unc_spike / unc.p95_latency_ms(
            2.0, 4.0),
        "f1_drop": 1.0 - ctl.mean_accuracy(4.5, 9.0) / base_acc,
        "min_accuracy_in_spike": ctl.min_accuracy(4.5, 9.0),
        "spike_p95_ms": ctl.p95_latency_ms(5.0, 9.0),
        "uncontrolled_spike_p95_ms": unc_spike,
        "post_spike_p95_ms": ctl.p95_latency_ms(9.5, 12.0),
        "infeasible_rows": sum(r.infeasible for r in ctl.rows),
        "fleet_cache_size": ctl.fleet_cache_size}
    bad = [k for k, ok in (
        ("uncontrolled_spike_over_base",
         claim["uncontrolled_spike_over_base"] > 8.0),
        ("f1_drop", claim["f1_drop"] <= 0.05),
        ("min_accuracy_in_spike", claim["min_accuracy_in_spike"] >= 0.95),
        ("spike_p95_ms", claim["spike_p95_ms"] <= 0.45 * unc_spike),
        ("post_spike_p95_ms", claim["post_spike_p95_ms"] < 130.0),
        ("infeasible_rows", claim["infeasible_rows"] == 0),
        ("fleet_cache_size", claim["fleet_cache_size"] == 1)) if not ok]
    if bad:
        raise AssertionError(f"paper claim missed on {bad}: {claim}")
    out["claim"] = claim
    out["fleet_tick_ms"] = {
        "polls": len(tick_ms), "p50": float(np.percentile(tick_ms, 50)),
        "p95": float(np.percentile(tick_ms, 95)),
        "max": float(np.max(tick_ms))}
    out["claim_trace"] = {k: tr[k] for k in (
        "ms_traced", "device_busy_ms", "device_busy_share",
        "device_activities", "tick_split")}

    # -- the goldens, byte for byte ------------------------------------------
    goldens = {}
    syn = {"scenario_fig11_small": {"complex": synthetic_table()},
           "scenario_tenant_flood": {"medium": synthetic_table()}}
    FK.frame_knob_grid.launches = 0
    syn["scenario_sceneshift_refresh"] = {cid: characterize(
        lambda cid=cid: SyntheticCamera(CameraConfig(
            camera_id=cid, dynamics="simple", seed=7)),
        clip_len=10, min_accuracy=0.90, device=dev) for cid in ("cam0",
                                                                "cam1")}
    shift_char_launches = FK.frame_knob_grid.launches
    if not shift_char_launches:
        raise AssertionError("the sceneshift tables never launched "
                             "frame_knob_grid")
    for name, tbls in syn.items():
        FK.frame_knob_grid.launches = 0
        res, _, tr = run(name, tbls,
                         trace=name == "scenario_sceneshift_refresh")
        got = res.to_json(indent=1) + "\n"
        want = (GOLDEN_DIR / f"{name}.json").read_text()
        if got != want:
            raise AssertionError(f"{name}: the card's trace differs from "
                                 f"tests/golden: "
                                 f"{first_difference(got, want)}")
        goldens[name] = {"rows": len(res.rows), "byte_equal": True}
        if tr is not None:
            resweeps = [e for e in res.events_log
                        if e["kind"] == "table_refresh"
                        and "re-swept" in e["detail"]]
            launches = FK.frame_knob_grid.launches
            if not resweeps or not launches:
                raise AssertionError(f"{name}: the drift re-sweep did not "
                                     f"run through the kernel ({launches} "
                                     f"launches, {len(resweeps)} re-sweeps)")
            out["resweep"] = {
                "resweeps": len(resweeps), "launches": launches,
                "kernel_device_ms": sum(v["ms"] for v in
                                        tr["kernel_ms"].values()),
                "table_launches": shift_char_launches}
    out["goldens"] = goldens

    # -- federation: a 1-broker herd is a lone broker; a 2-broker herd ------
    def drain_two(system):
        for cid, src in two_medium_cameras(system).items():
            for ts, f, _ in src.stream(8):
                system.cams[cid].publish(ts, f)
        sess = MezClient(system).open_session("app")
        sub = sess.subscribe(["cam0", "cam1"], 0.0, 100.0,
                             qos=QosBounds(0.1, 0.9))
        rows = []
        while (batch := sub.poll(max_frames=6)):
            rows.extend((d.camera_id, d.timestamp, d.knob_index,
                         d.wire_bytes, d.latency.total)
                        for d in batch.frames)
        sess.close()
        return rows

    lone = drain_two(MezSystem(calibrated_channel(seed=3), device=dev))
    herd = drain_two(FederatedMezSystem(calibrated_channel(seed=3),
                                        n_brokers=1, device=dev))
    if herd != lone or len(lone) != 16:
        raise AssertionError("a 1-broker herd's trace differs from "
                             "MezSystem's")
    fed, fed_ticks, _ = run("federated", {"medium": synthetic_table()})
    exactly_once(fed, FED_FRAMES)
    cr = fed.credit_stats
    migrated = sum(e["kind"] == "camera_migrated" for e in fed.events_log)
    if cr["leaked"] or cr["in_flight"] or migrated < 2:
        raise AssertionError(f"federated: ledger {cr}, {migrated} "
                             f"migration events")
    out["federated"] = {
        "credits": cr, "camera_migrated_events": migrated,
        "moves": [e.get("moves") for e in fed.events_log
                  if e["kind"] == "BrokerOverload"],
        "upgraded": [e.get("upgraded") for e in fed.events_log
                     if e["kind"] == "RollingUpgrade"],
        "tenants_admitted": sum(s["admitted"] for s in
                                fed.tenant_stats.values()),
        "fleet_tick_ms_p50": float(np.percentile(fed_ticks, 50)),
        "one_broker_herd_equals_mezsystem": True}

    # -- MQTT ingress: QoS 0 and 1 over a lossy hop ---------------------------
    mqtt = {}
    for qos in (0, 1):
        system = MezSystem(calibrated_channel(seed=3), device=dev)
        srcs = two_medium_cameras(system)
        bridge = MqttBridge(system, loss_rate=0.35, seed=11, max_retries=8)
        bridge.subscribe("mez/+/frames")
        sent, got = [], []
        for cid, src in srcs.items():
            for ts, frame, _ in src.stream(MQTT_FRAMES):
                if bridge.publish(topic_for(cid), frame, qos=qos,
                                  timestamp=ts).is_published():
                    sent.append((topic_for(cid), float(ts)))
            got.extend((m.topic, m.timestamp)
                       for m in bridge.pump(max_frames=64))
        stats = bridge.stats()
        if len(got) != len(set(got)) or sorted(got) != sorted(sent):
            raise AssertionError(f"MQTT QoS {qos}: delivered {len(got)} "
                                 f"({len(set(got))} distinct) of "
                                 f"{len(sent)} published")
        if qos == 1 and len(sent) != 2 * MQTT_FRAMES:
            raise AssertionError(f"MQTT QoS 1 landed {len(sent)} of "
                                 f"{2 * MQTT_FRAMES}: {stats}")
        mqtt[f"qos{qos}"] = stats
    out["mqtt"] = mqtt
    out["launches"] = char_launches + shift_char_launches + out[
        "resweep"]["launches"]
    return out

def mesh_fleet_run(dev, mesh) -> dict:
    """tests/test_fleet_sharded.py's 13 cameras through 36 fused ticks on
    ``mesh``, held lane by lane against host ``LatencyController``s; each
    tick timed on the host clock, ending in a synchronise."""
    import numpy as np
    import torch
    from repro_torch.core.characterization import LatencyRegression
    from repro_torch.core.controller import (ControllerConfig,
                                             FleetController,
                                             LatencyController)
    reg = LatencyRegression(slope=1.2e-6, intercept=0.008)

    class Cam:
        def __init__(self, cid, ctrl):
            self.camera_id, self.controller = cid, ctrl
            self.table_version = self.qos_version = 0

    cams, hosts = [], []
    for i in range(MESH_CAMS):
        tbl = synthetic_table(12 + i % 29, smin=2e3 + 37.0 * i,
                              smax=9e4 - 101.0 * i)
        cfg = ControllerConfig(latency_target=0.040 + 0.001 * (i % 17),
                               accuracy_target=0.90 + 0.002 * (i % 4))
        cams.append(Cam(f"cam{i:03d}", LatencyController(cfg, tbl, reg)))
        hosts.append(LatencyController(cfg, tbl, reg))
    fleet = FleetController(cams, capacity=128, mesh=mesh, device=dev)
    rng = np.random.default_rng(0)
    tick_ms = []
    for step in range(MESH_STEPS):
        if step == 10:
            for i in (2, 7, 12):
                fresh = synthetic_table(20 + i, smin=3e3 + 11.0 * i,
                                        smax=7e4)
                cams[i].controller.swap_table(fresh)
                cams[i].table_version += 1
                hosts[i].swap_table(fresh)
        if step == 22:
            for i in (0, 5):
                cams[i].controller.set_target(0.075, 0.91)
                cams[i].qos_version += 1
                hosts[i].set_target(0.075, 0.91)
        fb = {c.camera_id: float(rng.uniform(0.005, 0.5)) for c in cams}
        t0 = time.perf_counter()
        decisions = fleet.decide(fb)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        for i, cam in enumerate(cams):
            dh, df = hosts[i].update(fb[cam.camera_id]), \
                decisions[cam.camera_id]
            if (df.setting_index, df.acted, df.feasible) != (
                    dh.setting_index, dh.acted, dh.feasible):
                raise AssertionError(f"mesh {mesh}: step {step} lane {i}: "
                                     f"fleet {df} vs host {dh}")
    if fleet.cache_size() != 1:
        raise AssertionError(f"the meshed tick ran on {fleet.cache_size()} "
                             f"layouts")
    # (``--src`` may name a checkout whose unmeshed fleet has no mesh)
    devices = getattr(fleet.mesh, "devices", [fleet.device])
    return dict(devices=[str(d) for d in devices],
                lanes=fleet._n_padded, ticks=MESH_STEPS,
                identical_to_host=True, cache_size=fleet.cache_size(),
                tick_p50_ms=float(np.percentile(tick_ms, 50)),
                tick_p95_ms=float(np.percentile(tick_ms, 95)),
                first_tick_ms=tick_ms[0])


def production_bytes(arch: str) -> dict:
    """Bytes one rank stores at rest for ``arch`` at its published widths
    on each production mesh, by the specs: its share of every parameter
    leaf (the config's dtype) and of both float32 AdamW moments, beside
    the whole (a reckoning on meta tensors; nothing is allocated)."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.models.registry import param_specs
    from repro_torch.sharding import partition
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    leaves = tree_leaves(param_specs(cfg))

    def gb(shapes) -> float:
        return sum(math.prod(s) * (x.element_size() + 8)
                   for x, s in zip(leaves, shapes)) / 1e9

    out = {"whole_gb": gb([x.shape for x in leaves])}
    for label, multi in (("single", False), ("multi", True)):
        mesh = production_mesh_shape(multi)
        specs = partition.spec_leaves(partition.param_specs(
            param_specs(cfg), cfg, mesh))
        out[f"{label}_gb"] = gb([partition.NamedSharding(mesh, sp)
                                 .local_shape(x.shape)
                                 for x, sp in zip(leaves, specs)])
    return out


def phase_mesh(dev) -> dict:
    """The fleet mesh and the sharded training step on one card: the
    13-camera sequence on an 8-way split of one device (padded to 16
    lanes), on ``fleet_mesh(1)`` and unmeshed (``mesh=None``), each
    identical to the host controllers (the split on one card only adds
    launches: its p50 is a cost); tests/test_fleet_sharded.py's
    scenario meshed, unmeshed and on the host, byte-equal; then
    ``train(reduced=True, mesh_shape=(1, 1), grad_bits=8)`` on a one-rank
    NCCL group, its losses and final parameters bitwise the meshless
    run's, with the quantize pair's launches of the meshed run counted
    from zero (every launch contiguous)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import scenario as S
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch.train import train
    from repro_torch.sharding.partition import fleet_mesh
    from repro_torch.tree import tree_items
    cuda = dev.type == "cuda"
    card = (f"cuda:{torch.cuda.current_device()}" if cuda
            and dev.index is None else str(dev))
    out = {"fleet": {}}
    t0 = time.monotonic()
    for label, mesh in ((f"split{MESH_SPLIT}", [card] * MESH_SPLIT),
                        ("one", 1 if cuda else [card]), ("none", None)):
        out["fleet"][label] = mesh_fleet_run(
            dev, None if mesh is None else fleet_mesh(mesh))
    out["fleet"]["split_cost_ms"] = (
        out["fleet"][f"split{MESH_SPLIT}"]["tick_p50_ms"]
        - out["fleet"]["one"]["tick_p50_ms"])
    out["fleet"]["seconds"] = time.monotonic() - t0

    t0 = time.monotonic()

    def spec(**kw):
        return S.ScenarioSpec(
            name="fleet-sharded-parity",
            cameras=tuple(S.CameraSpec(f"cam{i}", dynamics="medium")
                          for i in range(3)),
            frames=30, seed=9, workload="jaad", latency=0.100,
            accuracy=0.92, events=(S.InterferenceSpike(
                start=2.0, end=4.0, factor=7.0),), **kw)

    tables = {"medium": synthetic_table()}
    runs = {k: S.run_scenario(spec(**kw), tables=tables, device=dev)
            for k, kw in (("meshed", dict(fleet=True,
                                          mesh=[card] * MESH_SPLIT)),
                          ("fleet", dict(fleet=True)),
                          ("host", dict(fleet=False)))}
    texts = {k: r.to_json() for k, r in runs.items()}
    if len(set(texts.values())) != 1 or runs["meshed"].fleet_cache_size != 1:
        raise AssertionError("the meshed scenario's trace differs: "
                             + str({k: len(v) for k, v in texts.items()}))
    out["scenario"] = dict(rows=len(runs["meshed"].rows),
                           identical=True, seconds=time.monotonic() - t0)

    # -- the sharded training step on a one-rank (1, 1) mesh ---------------
    t0 = time.monotonic()
    cfg = get_config(TRAIN_ARCH).reduced()
    n_leaves = len(grad_leaves(cfg))
    # one deterministic choice of every torch kernel for both runs: the
    # comparison is of the mesh path with the meshless one, bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        flat = train(TRAIN_ARCH, reduced=True, log_every=1000,
                     return_params=True, device=dev, **MESH_TRAIN)
        store_path = ROOT / "build" / "chip_smoke_mesh_store"
        store_path.parent.mkdir(parents=True, exist_ok=True)
        store_path.unlink(missing_ok=True)
        dist.init_process_group("nccl" if cuda else "gloo",
                                store=dist.FileStore(str(store_path), 1),
                                rank=0, world_size=1)
        Q.quantize_blocks.launches = Q.dequantize_blocks.launches = 0
        r0 = route_counts()
        try:
            meshed = train(TRAIN_ARCH, reduced=True, log_every=1000,
                           return_params=True, mesh_shape=(1, 1),
                           device=dev, **MESH_TRAIN)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
            store_path.unlink(missing_ok=True)
    finally:
        torch.use_deterministic_algorithms(False)
    launches = {"quantize_blocks": Q.quantize_blocks.launches,
                "dequantize_blocks": Q.dequantize_blocks.launches}
    routes = route_delta(r0, route_counts())
    want = n_leaves * MESH_TRAIN["steps"]
    if launches != {k: want for k in launches} \
            or routes != contiguous_only(want):
        raise AssertionError(f"the meshed train launched {launches} "
                             f"({routes} by route), want {want} of each, "
                             f"all contiguous")
    if meshed["losses"] != flat["losses"]:
        raise AssertionError(f"meshed losses {meshed['losses']} != "
                             f"{flat['losses']}")
    differ = [k for (k, a), (_, b) in zip(tree_items(meshed["params"]),
                                          tree_items(flat["params"]),
                                          strict=True)
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"meshed parameters differ from the meshless "
                             f"run's at {differ}")
    resident = meshed["resident"]
    n_params = sum(a.numel() for _, a in tree_items(flat["params"]))
    if resident != {"params": n_params, "moments": 2 * n_params}:
        raise AssertionError(f"one rank stores {resident}, want every "
                             f"element ({n_params})")
    out["train"] = dict(
        production_bytes_per_rank=production_bytes(TRAIN_ARCH),
        arch=TRAIN_ARCH, reduced=True, mesh_shape=[1, 1],
        backend="nccl" if cuda else "gloo",
        **MESH_TRAIN, losses=meshed["losses"], bitwise=True,
        resident=resident, launches=launches, launches_by_route=routes,
        step_p50_s=float(np.median(meshed["step_s"])),
        meshless_step_p50_s=float(np.median(flat["step_s"])),
        seconds=time.monotonic() - t0)
    del meshed, flat
    torch.cuda.empty_cache()
    return out


def lse_rel_err(got, want) -> float:
    """The largest over rows (a batch row's q head) of ``|lse - plain| /
    max(1, |plain|)``."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def phase_tp_lse(dev) -> list[dict]:
    """The decode kernel's log-sum-exp at the serve phase's decode shapes
    (qwen3's heads, B = ``SERVE_BATCH`` over ``DECODE_LENGTHS`` rows of
    ``DECODE_S_MAX``; float32 and bfloat16): held row by row against the
    plain version's within ``LSE_RTOL``, its output the same bits as the
    launch without it, and a planted fault -- the log-sum-exps shifted by
    one row -- read against the same limit (it must exceed it).  In
    bfloat16 both launches are timed behind the spin kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as DA
    cfg = get_config(SERVE_ARCH)
    if SERVE_REDUCED:
        cfg = cfg.reduced()
    qh, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for length in DECODE_LENGTHS:
            q = torch.randn((SERVE_BATCH, 1, qh, d), generator=g,
                            device=dev).to(dtype)
            kc, vc = (torch.randn((SERVE_BATCH, DECODE_S_MAX, kh, d),
                                  generator=g, device=dev).to(dtype)
                      for _ in range(2))
            out, lse = DA.decode_attention(q, kc, vc, length,
                                           return_lse=True)
            bare = DA.decode_attention(q, kc, vc, length)
            _, want = DA.decode_attention_plain(q, kc, vc, length,
                                                return_lse=True)
            shifted = lse.reshape(-1).roll(1).reshape(lse.shape)
            row = dict(shape=f"B={SERVE_BATCH} S_max={DECODE_S_MAX} "
                             f"QH={qh} KH={kh} D={d} length={length}",
                       dtype=str(dtype).removeprefix("torch."),
                       same_output=bool(torch.equal(out, bare)),
                       lse_rel_err=lse_rel_err(lse, want),
                       fault_shifted_row=lse_rel_err(shifted, want),
                       limit=LSE_RTOL)
            if dtype == torch.bfloat16:
                for key, fn in (("ms", lambda: DA.decode_attention(
                        q, kc, vc, length)), ("lse_ms", lambda:
                        DA.decode_attention(q, kc, vc, length,
                                            return_lse=True))):
                    ms, hidden = device_ms(fn, ATTN_REPS)
                    if not hidden:
                        raise AssertionError("the host outlasted the spin")
                    row[key] = ms
            rows.append(row)
            if not (row["same_output"] and row["lse_rel_err"] <= LSE_RTOL
                    < row["fault_shifted_row"]):
                raise AssertionError(f"decode log-sum-exp: {row}")
            del q, kc, vc, out, lse, bare, want, shifted
    torch.cuda.empty_cache()
    return rows


def tp_config():
    """``TP_ARCH`` as the tp phase serves it: the serve phase's config
    (the kernel routes), reduced under ``ZOO_REDUCED``."""
    return zoo_config(TP_ARCH)


def tp_cells():
    from repro_torch.configs.base import ShapeCell
    return (ShapeCell("tp_prefill", TP_PROMPT, TP_BATCH, "prefill"),
            ShapeCell("tp_decode", TP_PROMPT, TP_BATCH, "decode"))


def tp_inputs(dev, cfg) -> tuple:
    """The tp phase's parameters, prompt batch and decode tokens, drawn
    from one generator seeded with 0 on ``dev`` (every process of the
    two-process run draws the same)."""
    import torch
    from repro_torch.models.registry import build_model, make_batch
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = build_model(cfg).init_params(g, device=dev)
    batch = make_batch(cfg, TP_BATCH, TP_PROMPT, generator=g, device=dev)
    tokens = [torch.randint(0, cfg.vocab_size, (TP_BATCH, 1), generator=g,
                            device=dev, dtype=torch.int32)
              for _ in range(TP_STEPS)]
    return params, batch, tokens


def tp_serve(dev, cfg, params, batch, tokens, *, mesh=None,
             steps: "int | None" = None) -> dict:
    """``build_prefill_step`` / ``build_serve_step`` (one rank's steps on
    ``mesh``, its blocks taken from the whole arguments) of the tp cells:
    the prefill into a cache of ``TP_PROMPT + DECODE_SLACK`` rows, then
    ``steps`` decode steps; the last position's logits of each (the
    rank's block), the cache, and each step's seconds (host clock ending
    in a synchronise)."""
    import torch
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.registry import DECODE_SLACK, build_model
    pcell, dcell = tp_cells()
    pre = build_prefill_step(cfg, pcell, device=dev, mesh=mesh)
    srv = build_serve_step(cfg, dcell, device=dev, mesh=mesh)
    kw = {"enc_len": TP_PROMPT} if cfg.family == "audio" else {}
    cache = build_model(cfg).init_cache(TP_BATCH, TP_PROMPT + DECODE_SLACK,
                                        device=dev, **kw)
    if mesh is not None:
        coord = tuple(mesh.get_coordinate())
        params = _tp_blocks(params, pre.in_shardings[0], mesh, coord)
        batch = _tp_blocks(batch, pre.in_shardings[1], mesh, coord)
        cache = _tp_blocks(cache, pre.in_shardings[2], mesh, coord)
        tokens = [_tp_blocks(t, srv.in_shardings[1], mesh, coord)
                  for t in tokens]
    out = {"logits": [], "seconds": []}
    with torch.no_grad():
        for i in range(1 + (TP_STEPS if steps is None else steps)):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            if i == 0:
                logits, cache = pre.fn(params, batch, cache)
            else:
                logits, cache = srv.fn(params, tokens[i - 1], cache)
            torch.cuda.synchronize()
            out["seconds"].append(time.monotonic() - t0)
            out["logits"].append(logits[..., :cfg.vocab_size].clone())
    out["cache"] = cache
    return out


def cache_tensors(cache) -> list:
    """A cache's tensors, nested dataclasses in field order."""
    import dataclasses
    import torch
    out = []
    for f in dataclasses.fields(cache):
        x = getattr(cache, f.name)
        if dataclasses.is_dataclass(x):
            out += cache_tensors(x)
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def tp_family_launches(cfg) -> dict:
    """The kernel launches of one partitioned serve of the tp cells
    (a prefill, ``TP_STEPS`` decode steps) of ``cfg``'s family."""
    n, steps = cfg.num_layers, TP_STEPS
    if cfg.family == "ssm":
        return {"wkv_linear_scan": n * (1 + steps)}
    if cfg.family == "audio":
        dec = cfg.num_decoder_layers
        return {"flash_attention": n + 2 * dec,
                "decode_attention": 2 * dec * steps,
                "decode_attention_lse": 2 * dec * steps}
    inv = n // cfg.shared_attn_period
    return {"flash_attention": inv, "decode_attention": inv * steps,
            "decode_attention_lse": inv * steps}


def tp_family(dev, mesh, arch: str, layers: "int | None") -> dict:
    """``arch`` (``zoo_config``: the kernel routes, bfloat16) cut to
    ``layers`` where given, served by the partitioned prefill and decode
    steps on the one-rank ``mesh`` against the meshless steps on the same
    parameters and inputs: every step's logits and every cache tensor
    within ``STEP_RTOL`` (and whether bitwise), the kernel launches of
    the partitioned serve counted from zero (``tp_family_launches``;
    every decode launch with the log-sum-exp), prefill and decode p50
    seconds beside the meshless ones."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import linear_scan as LS
    from repro_torch.launch.dryrun import STEP_RTOL, rel_rms
    cfg = zoo_config(arch, layers)
    params, batch, tokens = tp_inputs(dev, cfg)
    tp_serve(dev, cfg, params, batch, tokens, steps=1)    # a warm-up
    meshless = tp_serve(dev, cfg, params, batch, tokens)
    counters = {"flash_attention": (FA.flash_attention, "launches"),
                "decode_attention": (DA.decode_attention, "launches"),
                "decode_attention_lse": (DA.decode_attention,
                                         "lse_launches"),
                "wkv_linear_scan": (LS.wkv_linear_scan, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    meshed = tp_serve(dev, cfg, params, batch, tokens, mesh=mesh)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    want = {k: 0 for k in counters}
    want.update(tp_family_launches(cfg))
    pairs = [(f"logits_{i}", a, b) for i, (a, b) in enumerate(
        zip(meshed["logits"], meshless["logits"]))]
    pairs += [(f"cache_{i}", a, b) for i, (a, b) in enumerate(
        zip(cache_tensors(meshed["cache"]),
            cache_tensors(meshless["cache"])))]
    errs = {k: rel_rms(a, b) for k, a, b in pairs}
    out = dict(
        arch=arch, layers=cfg.num_layers, batch=TP_BATCH, prompt=TP_PROMPT,
        steps=TP_STEPS, dtype=cfg.param_dtype, mesh_shape=[1, 1],
        launches=launches, max_rel_rms=max(errs.values()), limit=STEP_RTOL,
        bitwise=all(torch.equal(a, b) for _, a, b in pairs),
        prefill_s=meshed["seconds"][0],
        meshless_prefill_s=meshless["seconds"][0],
        decode_p50_s=statistics.median(meshed["seconds"][1:]),
        meshless_decode_p50_s=statistics.median(meshless["seconds"][1:]))
    del meshed, meshless, params, batch, tokens, pairs
    torch.cuda.empty_cache()
    print(json.dumps({"tp_family": out}), flush=True)
    off = {k: e for k, e in errs.items() if not e <= STEP_RTOL}
    if off or launches != want:
        raise AssertionError(f"the (1, 1) partitioned serve of {arch}: "
                             f"{off or launches} (launches wanted {want})")
    return out


def tp_rank_kernels(dev) -> list[dict]:
    """The flash, decode (with its log-sum-exp) and wkv kernels at one
    ``(16, 16)`` rank's shapes of the dry-run cells (``TP_RANK_CELLS``),
    through ``dryrun_kernel_rows``: row by row within 2^-6 of the plain
    versions (the wkv state within 1e-4, the log-sum-exps within
    ``LSE_RTOL``), each planted fault past its limit, timed behind the
    spin kernel beside the bound, the plain version and SDPA."""
    import dataclasses
    from repro_torch.configs import SHAPE_CELLS, get_config
    from repro_torch.models.registry import DECODE_SLACK
    m, rows = TP_RANK_M, []
    for arch, shape, full in TP_RANK_CELLS:
        cfg = get_config(arch)
        if ZOO_REDUCED:
            cfg = cfg.reduced()
        cell = SHAPE_CELLS[shape]
        if DRYRUN_SEQ:
            cell = dataclasses.replace(cell, seq_len=DRYRUN_SEQ[shape])
        cell = dataclasses.replace(cell, global_batch=max(
            1, cell.global_batch // m))
        if cell.kind == "prefill" or cfg.family == "ssm":
            # a prefill's (and the scan's) heads are the rank's
            cfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // m,
                                      num_kv_heads=max(
                                          1, cfg.num_kv_heads // m))
        elif cell.kind == "decode":
            # the last rank's row block: (S + slack) / m rows, of which
            # the last DECODE_SLACK are past the served length
            cell = dataclasses.replace(cell, seq_len=(
                cell.seq_len + DECODE_SLACK) // m - DECODE_SLACK)
        rows += dryrun_kernel_rows(dev, cfg, cell, arch, causal=not full,
                                   lse=cell.kind == "decode"
                                   and cfg.family != "ssm",
                                   tag="tp_rank_kernel")
    return rows


def tp_launches(tp: dict, name: str) -> dict:
    """``name``'s launches in each family's (1, 1) partitioned serve of
    the tp phase, by path, where it launched."""
    return {f"{a} ({f['layers']} layers) tp (1, 1)": f["launches"][name]
            for a, f in tp["families"].items() if f["launches"][name]}


def tp_rank_shapes(tp: dict, name: str) -> list:
    return [r for r in tp["rank_kernels"] if r["kernel"] == name]


def _tp_blocks(tree, specs, mesh, coord):
    """A rank's blocks of whole arguments (dicts and dataclasses), views
    where a coordinate's block is the whole tensor, copies elsewhere."""
    import dataclasses
    import torch
    from repro_torch.sharding import partition
    if isinstance(tree, dict):
        return {k: _tp_blocks(v, specs[k], mesh, coord)
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tp_blocks(getattr(tree, f.name), getattr(specs, f.name),
                               mesh, coord)
            for f in dataclasses.fields(tree)})
    if not isinstance(tree, torch.Tensor):
        return tree
    return partition.NamedSharding(mesh, specs).local_block(
        tree, coord).contiguous()


def tp_step_bytes(dev, cfg, mesh, reckoned: dict, params) -> dict:
    """The (1, 1) partitioned steps of the tp cells on the plain routes
    (``impl="chunked"``, the einsum decode: the routes the meta pass
    accounts) and on the kernel routes, each run once from fresh inputs
    (a zero cache; the decode cell's at ``length = TP_PROMPT``): the step
    bytes ``launch.dryrun.card_run`` measures (the arguments plus the
    peak allocated during the step over what was allocated before it)
    beside ``reckoned``, the meta pass's ``argument_bytes + temp_bytes``
    of the same step on a fake (1, 1) mesh."""
    import dataclasses
    import torch
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.meta import distinct_bytes
    from repro_torch.models.registry import DECODE_SLACK, build_model
    out = {}
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    for cell in tp_cells():
        for impl in ("chunked", "kernel"):
            build = (build_prefill_step if cell.kind == "prefill"
                     else build_serve_step)
            bundle = build(cfg, cell, impl=impl, device=dev, mesh=mesh)
            cache = build_model(cfg).init_cache(
                TP_BATCH, TP_PROMPT + DECODE_SLACK, device=dev)
            if cell.kind == "prefill":
                from repro_torch.models.registry import make_batch
                inp = make_batch(cfg, TP_BATCH, TP_PROMPT, generator=g,
                                 device=dev)
            else:
                cache = dataclasses.replace(cache, length=TP_PROMPT)
                inp = torch.randint(0, cfg.vocab_size, (TP_BATCH, 1),
                                    generator=g, device=dev,
                                    dtype=torch.int32)
            args = (params, inp, cache)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                res = bundle.fn(*args)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            measured = distinct_bytes(args) + peak - base
            want = reckoned[cell.kind]
            out[f"{cell.kind}_{impl}"] = dict(
                step_bytes=measured, reckoned_bytes=want,
                rel_err=abs(measured - want) / want)
            del bundle, cache, inp, args, res
            torch.cuda.empty_cache()
    return out


def tp_two_cells():
    """The two-process run's training cell: ``TP_TRAIN_BATCH`` x
    ``TP_TRAIN_SEQ``."""
    from repro_torch.configs.base import ShapeCell
    return ShapeCell("tp_train", TP_TRAIN_SEQ, TP_TRAIN_BATCH, "train")


def tp_train_config(cfg, hint: bool):
    """``cfg`` as the two-process run trains it: the chunked attention
    (the flash kernel has no backward), ``remat="full"``, the hint on or
    off."""
    import dataclasses
    return dataclasses.replace(cfg, attention_impl="chunked", remat="full",
                               sequence_parallel=hint)


def tp_two_train(dev, cfg, mesh, params, hint: bool) -> dict:
    """One training step of the rank on ``mesh`` (``build_train_bundle``
    of ``tp_two_cells()``, AdamW state from zero), its batch drawn from a
    generator seeded with 1: the loss, the step's seconds (synchronised),
    the allocated bytes before it, ``torch.cuda.max_memory_allocated``
    over it and its step bytes (the arguments plus the peak over what was
    allocated before: ``tp_step_bytes``'s measure)."""
    import torch
    from repro_torch.launch.steps import build_train_bundle
    from repro_torch.meta import distinct_bytes
    from repro_torch.models.registry import make_batch
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.tree import tree_map
    cfg = tp_train_config(cfg, hint)
    cell = tp_two_cells()
    bundle = build_train_bundle(cfg, cell, mesh=mesh, device=dev)
    coord = tuple(mesh.get_coordinate())
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    batch = make_batch(cfg, cell.global_batch, cell.seq_len, generator=g,
                       device=dev, train=True)
    # copies: AdamW writes the blocks in place, and a block that is the
    # whole leaf is a view of ``params``, which the next step starts from
    blocks = tree_map(lambda x: x.clone(), _tp_blocks(
        params, bundle.in_shardings[0], mesh, coord))
    state = init_opt_state(blocks, device=dev)
    rows = _tp_blocks(batch, bundle.in_shardings[2], mesh, coord)
    args = (blocks, state, rows)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    _, _, metrics = bundle.fn(*args)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    out = dict(hint=hint, loss=float(metrics["loss"]), seconds=seconds,
               allocated_before=base, max_memory_allocated=peak,
               step_bytes=distinct_bytes(args) + peak - base)
    del bundle, blocks, state, rows, args, batch, metrics
    torch.cuda.empty_cache()
    return out


def tp_two_rank(rank: int, root: str, dev_type: str, cfg,
                settings: dict) -> None:
    """One of the two processes of the model axis at 2 on one card, in a
    gloo group (the collectives carry host copies of the card's tensors:
    ``collectives.host_staged``): the tp prefill and ``TP_TWO_STEPS``
    decode steps of ``cfg`` under the ``sequence_parallel`` hint on a
    ``(1, 2)`` mesh, the kernels' launches counted from zero; then one
    training step with the hint off and one with it on
    (``tp_two_train``).  Its logits blocks, its cache's valid rows, the
    launches and the training records are saved under ``root`` (the
    parent's ``TP_*`` sizes in ``settings``); an exception's text is
    written instead."""
    import dataclasses
    import os
    import traceback
    import torch
    import torch.distributed as dist
    globals().update(settings)
    dev = torch.device("cuda", 0) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store"), 2), rank=rank, world_size=2)
    try:
        from repro_torch.kernels import decode_attention as DA
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((1, 2), ("data", "model"), device_type=dev.type)
        sp = dataclasses.replace(cfg, sequence_parallel=True)
        params, batch, tokens = tp_inputs(dev, sp)
        FA.flash_attention.launches = 0
        DA.decode_attention.launches = DA.decode_attention.lse_launches = 0
        got = tp_serve(dev, sp, params, batch, tokens, mesh=mesh,
                       steps=TP_TWO_STEPS)
        launches = {"flash_attention": FA.flash_attention.launches,
                    "decode_attention": DA.decode_attention.launches,
                    "decode_attention_lse":
                        DA.decode_attention.lse_launches}
        rows = got["cache"].k.shape[2]
        first = tuple(mesh.get_coordinate())[1] * rows
        valid = max(0, min(rows, TP_PROMPT + TP_TWO_STEPS - first))
        torch.save({"logits": [t.cpu() for t in got["logits"]],
                    "seconds": got["seconds"], "launches": launches,
                    "first_row": first,
                    "cache": [getattr(got["cache"], n)[:, :, :valid].cpu()
                              for n in ("k", "v")],
                    "coord": tuple(mesh.get_coordinate())},
                   os.path.join(root, f"rank{rank}.pt"))
        del got, batch, tokens
        train = [tp_two_train(dev, cfg, mesh, params, hint)
                 for hint in (False, True)]
        torch.save(train, os.path.join(root, f"train{rank}.pt"))
    except Exception:  # noqa: BLE001 - the outcome is the finding
        with open(os.path.join(root, f"error{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc()[-3000:])
    finally:
        dist.destroy_process_group()


def tp_two_spawn(dev, cfg) -> tuple:
    """Two ``tp_two_rank`` processes in a fresh directory: (the
    directory, the crash or error they ended with, or ``None``)."""
    import shutil
    import torch.multiprocessing as mp
    root = ROOT / "build" / "chip_smoke_tp_two"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    settings = {k: globals()[k] for k in (
        "TP_BATCH", "TP_PROMPT", "TP_STEPS", "TP_TWO_STEPS",
        "TP_TRAIN_BATCH", "TP_TRAIN_SEQ")}
    ctx = mp.start_processes(tp_two_rank, args=(str(root), dev.type, cfg,
                                                settings),
                             nprocs=2, join=False, start_method="spawn")
    t0, died = time.monotonic(), None
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() - t0 > TP_TWO_TIMEOUT_S:
                died = f"did not end in {TP_TWO_TIMEOUT_S} s"
                break
    except mp.ProcessExitedException as e:
        died = str(e)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    errors = sorted(root.glob("error*.txt"))
    return root, died or (errors[0].read_text()[-1500:] if errors else None)


def tp_two_reckoning(cfg) -> dict:
    """The ``--mesh`` reckoning of the two-process training step: one
    rank's argument plus temporary bytes of ``tp_two_cells()`` on a fake
    ``(1, 2)`` group, the hint off and on (``launch.dryrun.account_mesh``
    on meta)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    out = {}
    for hint in (False, True):
        with fake_mesh((1, 2), ("data", "model")) as fmesh:
            rec = dryrun.account_mesh(tp_train_config(cfg, hint),
                                      tp_two_cells(), fmesh)
        out[hint] = dict(bytes=rec["memory"]["argument_bytes"]
                         + rec["memory"]["temp_bytes"],
                         temp_bytes=rec["memory"]["temp_bytes"],
                         collectives={k: v["count"] for k, v in
                                      rec["collectives"].items()})
    return out


def tp_two_process(dev, cfg, meshless: dict) -> dict:
    """The model axis at 2 on the one card: two processes over gloo
    (NCCL refuses two ranks on one device), the collectives carrying host
    copies of the card's tensors (``collectives.host_staged``).  Under
    the ``sequence_parallel`` hint: each rank's logits blocks (its half
    of the vocabulary) and its cache rows held against the meshless
    serve's within ``STEP_RTOL``, the flash (at a rank's 8 of 16 query
    heads over the gathered 1024 rows) and decode launches counted; then
    the training step with the hint off and on, each process's
    ``torch.cuda.max_memory_allocated`` and step bytes beside the
    ``--mesh`` reckoning (``tp_two_reckoning``).  The step times measure
    the staging through the host, not NCCL.  Any failure fails the
    phase."""
    import shutil
    import torch
    from repro_torch.launch.dryrun import STEP_RTOL, rel_rms
    from repro_torch.sharding import partition
    t0 = time.monotonic()
    out = {"backend": "gloo (host-staged)", "mesh_shape": [1, 2],
           "hint": True, "steps": TP_TWO_STEPS,
           "reckoned": tp_two_reckoning(cfg)}
    root, failed = tp_two_spawn(dev, cfg)
    if failed:
        shutil.rmtree(root, ignore_errors=True)
        raise AssertionError(f"the two-process run: {failed}")
    mesh = partition.AbstractMesh((1, 2), ("data", "model"))
    sh = partition.NamedSharding(mesh, partition.logits_spec(
        (TP_BATCH, 1, cfg.padded_vocab), cfg, mesh))
    errs, cache_errs, ranks, bad = [], [], [], []
    for rank in range(2):
        got = torch.load(root / f"rank{rank}.pt", weights_only=False)
        # a decode step launches on a rank holding a valid row (rank 1's
        # rows start at 640 of the 1280 at full size)
        steps = sum(got["first_row"] <= TP_PROMPT + t
                    for t in range(TP_TWO_STEPS))
        launches = {"flash_attention": cfg.num_layers,
                    "decode_attention": cfg.num_layers * steps,
                    "decode_attention_lse": cfg.num_layers * steps}
        for a, b in zip(got["logits"], meshless["logits"]):
            want = torch.nn.functional.pad(
                b, (0, cfg.padded_vocab - cfg.vocab_size)).cpu()
            block = sh.local_block(want, got["coord"])
            n = min(a.shape[-1], cfg.vocab_size - got["coord"][1]
                    * block.shape[-1])
            errs.append(rel_rms(a[..., :n], block[..., :n]))
        first = got["first_row"]
        for name, rows in zip(("k", "v"), got["cache"]):
            whole = getattr(meshless["cache"], name)
            cache_errs.append(rel_rms(rows, whole[
                :, :, first:first + rows.shape[2]].cpu()))
        train = torch.load(root / f"train{rank}.pt", weights_only=False)
        if got["launches"] != launches or not \
                train[1]["max_memory_allocated"] \
                < train[0]["max_memory_allocated"]:
            bad.append(dict(rank=rank, launches_wanted=launches))
        ranks.append(dict(rank=rank, launches=got["launches"],
                          prefill_s=got["seconds"][0],
                          decode_p50_s=statistics.median(
                              got["seconds"][1:]),
                          cache_rows=[first, first + got["cache"][0]
                                      .shape[2]],
                          train=train))
        del got
    shutil.rmtree(root, ignore_errors=True)
    out.update(logits_rel_rms=max(errs), cache_rel_rms=max(cache_errs),
               limit=STEP_RTOL, ranks=ranks,
               seconds=time.monotonic() - t0)
    if not (max(errs) <= STEP_RTOL and max(cache_errs) <= STEP_RTOL) \
            or bad:
        raise AssertionError(f"the two-process run: {bad} {out}")
    return out


def phase_tp(dev) -> dict:
    """Tensor-parallel compute on the card: the decode kernel's
    log-sum-exp (``phase_tp_lse``); ``TP_ARCH`` at its published widths in
    bfloat16 through the partitioned prefill and decode steps on a
    one-rank NCCL ``(1, 1)`` mesh against the meshless steps (the same
    kernels): logits and written cache rows within ``STEP_RTOL`` (and
    whether bitwise), 28 flash launches a prefill and 28 decode launches
    with the log-sum-exp a step counted from zero; the measured step bytes
    of the (1, 1) steps against the ``--mesh`` meta reckoning of the same
    steps (``tp_step_bytes``, within ``TP_BYTES_RTOL`` on the plain
    routes); the other families the same way (``tp_family`` over
    ``TP_FAMILIES``); the three kernels at one ``(16, 16)`` rank's shapes
    (``tp_rank_kernels``); the ``(1, 1)`` serve under the
    ``sequence_parallel`` hint bitwise the meshless one; then the model
    axis at 2 in two processes over gloo under the hint, serve and
    training step (``tp_two_process``)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh, make_mesh
    out = {"lse": phase_tp_lse(dev)}
    cfg = tp_config()
    plain = dataclasses.replace(cfg, attention_impl="chunked")
    t0 = time.monotonic()
    reckoned = {}
    for cell in tp_cells():
        with fake_mesh((1, 1), ("data", "model")) as fmesh:
            rec = dryrun.account_mesh(plain, cell, fmesh)
        reckoned[cell.kind] = (rec["memory"]["argument_bytes"]
                               + rec["memory"]["temp_bytes"])
    out["reckon_seconds"] = time.monotonic() - t0
    params, batch, tokens = tp_inputs(dev, cfg)
    tp_serve(dev, cfg, params, batch, tokens, steps=1)    # a warm-up
    meshless = tp_serve(dev, cfg, params, batch, tokens)
    store = ROOT / "build" / "chip_smoke_tp_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(str(store), 1), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
        FA.flash_attention.launches = 0
        DA.decode_attention.launches = DA.decode_attention.lse_launches = 0
        meshed = tp_serve(dev, cfg, params, batch, tokens, mesh=mesh)
        launches = {"flash_attention": FA.flash_attention.launches,
                    "decode_attention": DA.decode_attention.launches,
                    "decode_attention_lse":
                        DA.decode_attention.lse_launches}
        want = {"flash_attention": cfg.num_layers,
                "decode_attention": cfg.num_layers * TP_STEPS,
                "decode_attention_lse": cfg.num_layers * TP_STEPS}
        if launches != want:
            raise AssertionError(f"the (1, 1) serve launched {launches}, "
                                 f"want {want}")
        # the sequence_parallel hint at model axis 1: nothing splits
        hinted = tp_serve(dev, dataclasses.replace(
            cfg, sequence_parallel=True), params, batch, tokens, mesh=mesh)
        hint_bitwise = all(torch.equal(a, b) for a, b in zip(
            hinted["logits"], meshless["logits"])) and all(
            torch.equal(getattr(hinted["cache"], n), getattr(
                meshless["cache"], n)) for n in ("k", "v"))
        del hinted
        if not hint_bitwise:
            raise AssertionError("the (1, 1) serve under the "
                                 "sequence_parallel hint is not bitwise "
                                 "the meshless one")
        out["bytes"] = tp_step_bytes(dev, cfg, mesh, reckoned, params)
        # rwkv6, enc-dec and zamba2 partitioned the same way
        families = {a: tp_family(dev, mesh, a, n) for a, n in TP_FAMILIES}
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    errs = {f"logits_{i}": dryrun.rel_rms(a, b) for i, (a, b) in enumerate(
        zip(meshed["logits"], meshless["logits"]))}
    rows = TP_PROMPT + TP_STEPS
    for name in ("k", "v"):
        errs[f"cache_{name}"] = dryrun.rel_rms(
            getattr(meshed["cache"], name)[:, :, :rows],
            getattr(meshless["cache"], name)[:, :, :rows])
    bitwise = all(torch.equal(a, b) for a, b in zip(
        meshed["logits"], meshless["logits"])) and all(
        torch.equal(getattr(meshed["cache"], n), getattr(
            meshless["cache"], n)) for n in ("k", "v"))
    out["serve"] = dict(
        arch=TP_ARCH, batch=TP_BATCH, prompt=TP_PROMPT, steps=TP_STEPS,
        dtype=cfg.param_dtype, mesh_shape=[1, 1],
        backend="nccl" if dev.type == "cuda" else "gloo",
        launches=launches, max_rel_rms=max(errs.values()),
        limit=dryrun.STEP_RTOL, bitwise=bitwise,
        hint_bitwise=hint_bitwise,
        prefill_s=meshed["seconds"][0],
        meshless_prefill_s=meshless["seconds"][0],
        decode_p50_s=statistics.median(meshed["seconds"][1:]),
        meshless_decode_p50_s=statistics.median(meshless["seconds"][1:]))
    del meshed
    torch.cuda.empty_cache()
    off = {k: e for k, e in errs.items() if not e <= dryrun.STEP_RTOL}
    far = {k: r for k, r in out["bytes"].items()
           if k.endswith("chunked") and not r["rel_err"] <= TP_BYTES_RTOL}
    if off or far:
        raise AssertionError(f"the (1, 1) partitioned serve: {off or far}")
    out["families"] = families
    out["rank_kernels"] = tp_rank_kernels(dev)
    out["two_process"] = tp_two_process(dev, cfg, meshless)
    del meshless, params
    torch.cuda.empty_cache()
    return out


def phase_camera(dev) -> tuple[dict, dict]:
    """The camera node's phases in order; returns (frame_knobs_kernel
    result, camera_node result) and emits one line per phase."""
    t0 = time.monotonic()
    knobs = phase_frame_knobs_kernel(dev)
    emit("frame_knobs_kernel", seconds=time.monotonic() - t0, **knobs)
    t0 = time.monotonic()
    cam = phase_camera_node(dev)
    emit("camera_node", seconds=time.monotonic() - t0, **cam)
    return knobs, cam


def knobs_kernel_row(knobs: dict, cam: dict) -> dict:
    """The ``kernels`` line's row of ``frame_knobs``: launches from the
    camera path, its time on the path's inputs (a window's float32 gray
    planes, consecutive pairs, blur 5) with the bound and the plain
    version; the kernel phase's times on independent float32 and uint8
    frames and prev beside them."""
    f32, u8 = (next(r for r in knobs["timings"] if r["dtype"] == dt
                    and r["case"] == "independent"
                    and r["blur_k"] == KNOBS_BLUR)
               for dt in ("float32", "uint8"))
    return {
        "name": "frame_knobs", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/frame_knobs.cu",
        "replaces": "src/repro/kernels/frame_knobs.py:107",
        "launches": cam["launches"],
        "launches_by_route": cam["launches_by_route"],
        "max_abs_err": knobs["max_abs_err"],
        "ms": cam["ms"], "plain_ms": cam["plain_ms"],
        "bound_ms": cam["bound_ms"], "bound_by": cam["bound_by"],
        "library_ms": None,
        "independent_float32_ms": f32["ms"],
        "independent_float32_bound_ms": f32["bound_ms"],
        "uint8_ms": u8["ms"], "uint8_plain_ms": u8["plain_ms"],
        "uint8_bound_ms": u8["bound_ms"],
        "shape": f"float32 gray [{KNOBS_N}, {H}, {W}], blur_k "
                 f"{KNOBS_BLUR} (one camera's {CAM_WINDOW}-frame window)"}


def ptxas_functions(paths) -> list[dict]:
    """Each kernel function in the ``-Xptxas -v`` logs of ``paths`` (name
    -> library): its source, mangled name, registers and spill bytes
    (stores + loads)."""
    out = []
    for src, pth in paths.items():
        cur = None
        for ln in Path(str(pth) + ".log").read_text().splitlines():
            if m := re.search(r"Compiling entry function '(\w+)'", ln):
                cur = dict(source=src, function=m.group(1), registers=None,
                           spill_bytes=0)
                out.append(cur)
            elif cur is None:
                continue
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                r"spill loads", ln):
                cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            elif m := re.search(r"Used (\d+) registers", ln):
                cur["registers"] = int(m.group(1))
    return out


def main(argv: list[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--grid-only", action="store_true",
                      help="run only the build, kernel and profile phases "
                           "of frame_knob_grid")
    only.add_argument("--quant-only", action="store_true",
                      help="run only the build and quant_kernels phases of "
                           "the quantize pair")
    only.add_argument("--wkv-only", action="store_true",
                      help="run only the build and rwkv_kernels phases of "
                           "the wkv scan")
    only.add_argument("--knobs-only", action="store_true",
                      help="run only the build and frame_knobs_kernel "
                           "phases of the camera node's knob kernel")
    only.add_argument("--scenario-only", action="store_true",
                      help="run only the build of frame_knob_grid and the "
                           "scenario phase")
    only.add_argument("--zoo-only", action="store_true",
                      help="run only the build of the attention kernels and "
                           "the serve_zoo phase")
    only.add_argument("--families-only", action="store_true",
                      help="run only the build of the attention kernels and "
                           "the serve_families phase")
    only.add_argument("--encdec-only", action="store_true",
                      help="run only the build of the attention kernels and "
                           "the serve_encdec phase")
    only.add_argument("--train-families-only", action="store_true",
                      help="run only the build of the quantize pair and "
                           "the train_families phase")
    only.add_argument("--dryrun-only", action="store_true",
                      help="run only the build of the attention and wkv "
                           "kernels and the dryrun phase")
    only.add_argument("--remat-only", action="store_true",
                      help="run only the build of the quantize pair and "
                           "the remat phase")
    only.add_argument("--tp-only", action="store_true",
                      help="run only the build of the attention kernels "
                           "and the wkv scan, and the tp phase")
    only.add_argument("--mesh-only", action="store_true",
                      help="run only the build of the quantize pair and "
                           "the mesh phase")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the src/ directory whose repro_torch to drive "
                         "(default: this checkout's); with one of the "
                         "--*-only modes, another checkout's, to time its "
                         "kernels with this script's phases")
    args = ap.parse_args(argv)
    if not (args.src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found -- run from the root "
              "of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the plain version's and the torch-op stages' f32 must stay f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    (run_grid if args.grid_only else run_quant if args.quant_only
     else run_wkv if args.wkv_only else run_knobs if args.knobs_only
     else run_scenario_phase if args.scenario_only
     else run_zoo if args.zoo_only
     else run_families if args.families_only
     else run_encdec if args.encdec_only
     else run_train_families if args.train_families_only
     else run_dryrun if args.dryrun_only
     else run_remat if args.remat_only
     else run_mesh if args.mesh_only
     else run_tp if args.tp_only
     else run)(torch.device("cuda"))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def grid_sums(rows: list[dict]) -> dict:
    """The kernel phase's times summed per case."""
    return {case: {k: sum(r[k] for r in rows if r["case"] == case)
                   for k in ("ms", "traced_ms", "call_ms", "plain_ms",
                             "bound_ms")}
            for case in ("check", "characterize", "resweep")}


def run_grid(dev) -> None:
    """``--grid-only``: build ``frame_knob_grid``, then the kernel and
    profile phases, with the spin's hiding recorded rather than required
    (a wrapper that synchronises inside a call cannot be hidden)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import frame_knobs as FK
    t0 = time.monotonic()
    paths = build.build(["frame_knob_grid"])
    FK._load_lib()
    emit("build", seconds=time.monotonic() - t0,
         functions=ptxas_functions(paths))
    t0 = time.monotonic()
    rows, worst = phase_kernel(dev, need_hidden=False)
    torch.cuda.empty_cache()
    emit("kernel", seconds=time.monotonic() - t0, groups=len(rows),
         max_abs_err=worst[0], max_mismatch=worst[1],
         per_case=grid_sums(rows))
    t0 = time.monotonic()
    prof = phase_profile(dev)
    emit("profile", seconds=time.monotonic() - t0, **prof)


def build_only(name: str, load) -> None:
    """Build ``csrc/<name>.cu``, bind it with its wrapper's ``load``, emit
    the build line and fail if a function of ``NO_SPILL`` spills (a
    checkout's older kernels, under other names, are listed but not held
    to it)."""
    from repro_torch.kernels import build
    t0 = time.monotonic()
    paths = build.build([name])
    load()
    functions = ptxas_functions(paths)
    emit("build", seconds=time.monotonic() - t0, functions=functions)
    spilled = [f for f in functions if f["spill_bytes"]
               and any(k in f["function"] for k in NO_SPILL)]
    if spilled:
        raise AssertionError(f"redesigned kernels spilling: {spilled}")


def run_quant(dev) -> None:
    """``--quant-only``: build the quantize pair, then the quant_kernels
    phase (a checkout whose wrappers count no routes is checked and timed
    all the same)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import quantize as Q
    build_only("quantize_blocks", Q._load_lib)
    cfg = get_config(TRAIN_ARCH)
    if TRAIN_REDUCED:
        cfg = cfg.reduced()
    t0 = time.monotonic()
    quant = phase_quant_kernels(dev, cfg)
    emit("quant_kernels", seconds=time.monotonic() - t0, **quant)


def run_wkv(dev) -> None:
    """``--wkv-only``: build the wkv scan, then the rwkv_kernels phase
    (``phase_wkv_kernels``: both dtypes, every ``WKV_SHAPES`` case)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import linear_scan as LS
    build_only("wkv_linear_scan", LS._load_lib)
    cfg = get_config(RWKV_ARCH)
    if RWKV_REDUCED:
        cfg = cfg.reduced()
    t0 = time.monotonic()
    rows = phase_wkv_kernels(dev, cfg)
    emit("rwkv_kernels", seconds=time.monotonic() - t0, cases=len(rows),
         timings=[{k: r[k] for k in ("dtype", "shape", "ms", "plain_ms",
                                     "bound_ms", "call_ms")}
                  for r in rows if "ms" in r])


def run_knobs(dev) -> None:
    """``--knobs-only``: build the knob kernel, then the
    frame_knobs_kernel phase (a checkout whose wrapper counts no routes is
    checked and timed all the same)."""
    from repro_torch.kernels import frame_knobs as FK
    build_only("frame_knobs", FK._load_knobs_lib)
    t0 = time.monotonic()
    knobs = phase_frame_knobs_kernel(dev)
    emit("frame_knobs_kernel", seconds=time.monotonic() - t0, **knobs)


def run_scenario_phase(dev) -> None:
    """``--scenario-only``: build ``frame_knob_grid``, then the scenario
    phase."""
    from repro_torch.kernels import frame_knobs as FK
    build_only("frame_knob_grid", FK._load_lib)
    t0 = time.monotonic()
    scen = phase_scenario(dev)
    emit("scenario", seconds=time.monotonic() - t0, **scen)


def run_zoo(dev) -> None:
    """``--zoo-only``: build the two attention kernels, then the serve_zoo
    phase."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    build_only("flash_attention", FA._load_lib)
    build_only("decode_attention", DA._load_lib)
    phase_serve_zoo(dev)


def run_families(dev) -> None:
    """``--families-only``: build the two attention kernels, then the
    serve_families phase."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    build_only("flash_attention", FA._load_lib)
    build_only("decode_attention", DA._load_lib)
    phase_serve_families(dev)


def run_encdec(dev) -> None:
    """``--encdec-only``: build the two attention kernels, then the
    serve_encdec phase."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    build_only("flash_attention", FA._load_lib)
    build_only("decode_attention", DA._load_lib)
    phase_serve_encdec(dev)


def run_train_families(dev) -> None:
    """``--train-families-only``: build the quantize pair, then the
    train_families phase."""
    from repro_torch.kernels import quantize as Q
    build_only("quantize_blocks", Q._load_lib)
    phase_train_families(dev)


def run_dryrun(dev) -> None:
    """``--dryrun-only``: build the two attention kernels and the wkv scan,
    then the dryrun phase."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import linear_scan as LS
    t0 = time.monotonic()
    paths = build.build(["flash_attention", "decode_attention",
                         "wkv_linear_scan"])
    for mod in (FA, DA, LS):
        mod._load_lib()
    emit("build", seconds=time.monotonic() - t0,
         functions=ptxas_functions(paths))
    phase_dryrun(dev)


def run_remat(dev) -> None:
    """``--remat-only``: build the quantize pair, then the remat phase."""
    from repro_torch.kernels import quantize as Q
    build_only("quantize_blocks", Q._load_lib)
    phase_remat(dev)


def run_mesh(dev) -> None:
    """``--mesh-only``: build the quantize pair, then the mesh phase."""
    from repro_torch.kernels import quantize as Q
    build_only("quantize_blocks", Q._load_lib)
    t0 = time.monotonic()
    mesh = phase_mesh(dev)
    emit("mesh", seconds=time.monotonic() - t0, **mesh)


def run_tp(dev) -> None:
    """``--tp-only``: build the two attention kernels and the wkv scan,
    then the tp phase."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import linear_scan as LS
    build_only("flash_attention", FA._load_lib)
    build_only("decode_attention", DA._load_lib)
    build_only("wkv_linear_scan", LS._load_lib)
    t0 = time.monotonic()
    tp = phase_tp(dev)
    emit("tp", seconds=time.monotonic() - t0, **tp)


def run(dev) -> None:
    """Every phase on ``dev``; raises on any failure."""
    import torch
    t0 = time.monotonic()
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import frame_knobs as FK
    from repro_torch.kernels import linear_scan as LS
    from repro_torch.kernels import quantize as Q
    paths = build.build()
    for mod in (FK, FA, DA, LS, Q):
        mod._load_lib()
    FK._load_knobs_lib()
    ptxas = [ln.strip() for pth in paths.values()
             for ln in Path(str(pth) + ".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    functions = ptxas_functions(paths)
    redesigned = [f for f in functions
                  if any(k in f["function"] for k in NO_SPILL)]
    emit("build", seconds=time.monotonic() - t0, kernels=sorted(paths),
         ptxas=ptxas, redesigned=redesigned)
    spilled = [f for f in redesigned if f["spill_bytes"]]
    if len({k for k in NO_SPILL for f in redesigned
            if k in f["function"]}) != len(NO_SPILL) or spilled:
        raise AssertionError(f"redesigned kernels missing or spilling: "
                             f"{spilled or redesigned}")

    import numpy as np
    from repro_torch.configs.mez_edge import CONFIG
    from repro_torch.core import knobs as K
    from repro_torch.core.api import QosBounds, SubscriptionOptions
    from repro_torch.core.broker import MezSystem
    from repro_torch.core.channel import calibrated_channel
    from repro_torch.core.characterization import (characterize,
                                                   fit_latency_regression)
    from repro_torch.core.session import MezClient
    from repro_torch.data.camera import CameraConfig, SyntheticCamera

    t0 = time.monotonic()
    rows, worst = phase_kernel(dev)
    torch.cuda.empty_cache()
    emit("kernel", seconds=time.monotonic() - t0, groups=len(rows),
         max_abs_err=worst[0], max_mismatch=worst[1],
         per_case=grid_sums(rows))

    # -- the main path: characterize, then the closed loop ------------------
    n_groups = len(K.RESOLUTION_SCALES) * len(K.COLORSPACES)
    FK.frame_knob_grid.launches = 0
    t0 = time.monotonic()
    # traced, for the card's busy share of a sweep (the profiler's own
    # host cost is inside these seconds)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        table = characterize(
            lambda: SyntheticCamera(CameraConfig(
                height=H, width=W, dynamics="complex", seed=CONFIG.seed)),
            clip_len=CLIP_LEN, include_artifact=True, engine="batched",
            min_accuracy=TABLE_FLOOR, device=dev)
        torch.cuda.synchronize()
        char_s = time.monotonic() - t0
    char_launches = FK.frame_knob_grid.launches
    if char_launches != n_groups:
        raise AssertionError(f"characterize launched the kernel "
                             f"{char_launches} times, want {n_groups}")
    if not table.settings:
        raise AssertionError("characterization kept no settings")
    if not table.includes_artifact:
        # the kernel phase checked the re-sweep's shape with knob4, which
        # the re-sweep takes from the live table
        raise AssertionError("the table kept no knob4 setting")
    if len(set(table.best_idx.tolist())) < 2:
        raise AssertionError("the table offers the controller one setting")
    busy_s, n_activities = device_busy_s(prof)
    del prof
    emit("characterize", seconds=char_s, kept=len(table.settings),
         launches=char_launches, includes_artifact=table.includes_artifact,
         size_range=[float(table.sizes_sorted[0]),
                     float(table.sizes_sorted[-1])],
         device_busy_s=busy_s if n_activities else None,
         device_busy_share=busy_s / char_s if n_activities else None,
         device_activities=n_activities)

    FK.frame_knob_grid.launches = 0
    t0 = time.monotonic()
    # raw wire sizes: the "jaad"/"dukemtmc" scales map 144x256 synthetic
    # frames onto the paper's footage sizes, and these frames already have
    # the paper's 1920x1080 pixels -- scaling them again counts size twice
    channel = calibrated_channel(seed=3)
    system = MezSystem(channel, device=dev)
    # fit the latency model where the controller trades: the table's sizes
    # whose mean latency stays within twice the bound.  A line through the
    # whole 1 kB - 5 MB range of a 1080p table is far off at the small
    # end, and the PI steps never reach it.
    grid = np.asarray(table.sizes_sorted, np.float64)
    near = grid[channel.regression_points(
        grid, n=N_CAMS, fps=CONFIG.fps, distance_m=CONFIG.distance_m)
        <= 2 * CONFIG.latency_target]
    if near.size < 2:
        raise AssertionError("no table size meets twice the latency bound")
    sizes = np.linspace(near[0], near[-1], 12)
    reg = fit_latency_regression(
        sizes, channel.regression_points(sizes, n=N_CAMS, fps=CONFIG.fps,
                                         distance_m=CONFIG.distance_m))
    cam_ids = [f"cam{i}" for i in range(N_CAMS)]
    for cid in cam_ids:
        cam = system.add_camera(cid, distance_m=CONFIG.distance_m,
                                fps=CONFIG.fps)
        src = SyntheticCamera(CameraConfig(camera_id=cid, height=H, width=W,
                                           dynamics="complex",
                                           fps=CONFIG.fps, seed=CONFIG.seed))
        cam.background = src.background
        cam.set_target(CONFIG.latency_target, CONFIG.accuracy_target, table,
                       reg)
        for ts, frame, _ in src.stream(N_FRAMES):
            cam.publish(ts, frame)
    publish_s = time.monotonic() - t0
    qos = QosBounds(CONFIG.latency_target, CONFIG.accuracy_target)
    session = MezClient(system).open_session("smoke")
    sub = session.subscribe(cam_ids, 0.0, 1e9, qos=qos,
                            options=SubscriptionOptions(fleet=True))
    # the first half of every stream under the paper's bounds, then a
    # retarget to a latency the best setting cannot meet: the fused tick
    # on the card must move every lane to another setting
    before, after = [], []
    while len(before) < N_CAMS * N_FRAMES // 2 and (
            batch := sub.poll(max_frames=2 * N_CAMS)):
        before.extend(batch.frames)
    sub.update_qos(latency=RETARGET_LATENCY)
    while (batch := sub.poll(max_frames=2 * N_CAMS)):
        after.extend(batch.frames)
    delivered = before + after
    shipped = [d for d in delivered if d.frame is not None]
    if len(delivered) != N_CAMS * N_FRAMES or not shipped:
        raise AssertionError(f"delivered {len(delivered)} frames "
                             f"({len(shipped)} shipped), want "
                             f"{N_CAMS * N_FRAMES}")
    lat = np.asarray([d.latency.total for d in shipped])
    if not np.isfinite(lat).all():
        raise AssertionError("non-finite latency")
    for cid in cam_ids:
        ts = [d.timestamp for d in delivered if d.camera_id == cid]
        if ts != sorted(ts) or len(ts) != N_FRAMES:
            raise AssertionError(f"{cid}: frames out of order or missing")
    fleet = system.edge.subscription_fleet(sub.subscription_id)
    if fleet is None:
        raise AssertionError("the fleet control plane never ran")
    p95 = float(np.percentile(lat, 95))

    def served(frames):
        """(p95 latency, lowest normalized F1) of the shipped frames (None
        when every frame was dropped; raw frames, knob_index -1, are full
        quality), the (camera, setting) pairs of every frame, and the
        number of frames the chosen settings dropped (knob5)."""
        ship = [d for d in frames if d.frame is not None]
        acc = [float(system.cams[d.camera_id].controller.table
                     .acc_by_setting[d.knob_index])
               if d.knob_index >= 0 else 1.0 for d in ship]
        return (float(np.percentile([d.latency.total for d in ship], 95))
                if ship else None, min(acc, default=None),
                {(d.camera_id, d.knob_index) for d in frames},
                len(frames) - len(ship))

    p95_before, acc_before, set_before, drop_before = served(before)
    p95_after, acc_after, set_after, drop_after = served(after)
    if (p95 > CONFIG.latency_target or acc_before is None
            or acc_before < CONFIG.accuracy_target):
        raise AssertionError(f"bounds missed: p95 {p95} s over every frame, "
                             f"lowest accuracy served under the paper's "
                             f"bounds {acc_before}")
    moved = {c for c, _ in set_after - set_before}
    if moved != set(cam_ids):
        raise AssertionError(f"the fleet tick did not move every lane on the "
                             f"retarget: moved {sorted(moved)}")
    events = [e.kind.name for e in sub.events()]
    loop_launches = FK.frame_knob_grid.launches
    t1 = time.monotonic()
    sub2 = session.subscribe(["cam0"], 0.0, 1e9, qos=qos,
                             options=SubscriptionOptions(fleet=True))
    upd = sub2.update_qos(latency=0.060, recharacterize=True)
    torch.cuda.synchronize()
    rechar_launches = FK.frame_knob_grid.launches - loop_launches
    if upd.recharacterized != ("cam0",) or rechar_launches != n_groups:
        raise AssertionError(f"re-sweep of cam0 did not run on the card: "
                             f"{upd.recharacterized}, {rechar_launches} "
                             f"launches")
    more = sub2.poll(max_frames=4)
    main_launches = char_launches + FK.frame_knob_grid.launches
    emit("loop", seconds=time.monotonic() - t0, publish_seconds=publish_s,
         recharacterize_seconds=time.monotonic() - t1,
         delivered=len(delivered), shipped=len(shipped),
         p95_latency_s=p95, latency_bound_s=CONFIG.latency_target,
         accuracy_bound=CONFIG.accuracy_target,
         before_retarget=dict(frames=len(before), dropped=drop_before,
                              p95_latency_s=p95_before,
                              min_accuracy_served=acc_before,
                              settings=sorted({k for _, k in set_before})),
         after_retarget=dict(latency_bound_s=RETARGET_LATENCY,
                             frames=len(after), dropped=drop_after,
                             p95_latency_s=p95_after,
                             min_accuracy_served=acc_after,
                             settings=sorted({k for _, k in set_after})),
         median_wire_bytes=float(np.median([d.wire_bytes for d in shipped])),
         events=sorted(set(events)), recharacterized=list(
             upd.recharacterized), launches=rechar_launches,
         post_refresh_frames=len(more))

    t0 = time.monotonic()
    prof = phase_profile(dev)
    emit("profile", seconds=time.monotonic() - t0, **prof)

    # -- the serving path: qwen3-1.7b at its published widths ---------------
    attn_rows, timed = phase_serve(dev)
    # -- the SSM family's serving path: rwkv6-1.6b at its published widths --
    wkv_kernel = wkv_kernel_row(*phase_serve_rwkv(dev))
    # -- the other dense configs and the MoE family, at published widths --
    zoo_rows, zoo_serves = phase_serve_zoo(dev)
    # -- the VLM and hybrid families, at published widths -----------------
    fam_rows, fam_serves = phase_serve_families(dev)
    # -- the audio enc-dec family, at published widths --------------------
    enc_rows, enc_timed = phase_serve_encdec(dev)
    # -- training qwen3-1.7b with the approximate collective's round trip --
    quant, train_run = phase_training(dev)
    # -- training every family, at published widths (some cut in depth) --
    families = phase_train_families(dev)
    # -- remat="dots" against "full" and "none", a dots step, the example --
    remat = phase_remat(dev)
    # -- the dry-run: every cell on meta, five cut cells on the card -----
    dry = phase_dryrun(dev)
    # -- the camera node: device rings and the knob kernel ----------------
    knobs_row = knobs_kernel_row(*phase_camera(dev))
    # -- the scripted-experiment path: scenarios, federation, MQTT ---------
    t0 = time.monotonic()
    scen = phase_scenario(dev)
    emit("scenario", seconds=time.monotonic() - t0, **scen)
    # -- the fleet mesh and the sharded training step -----------------------
    t0 = time.monotonic()
    mesh = phase_mesh(dev)
    emit("mesh", seconds=time.monotonic() - t0, **mesh)
    # -- tensor-parallel compute: the partitioned serve on a (1, 1) mesh ----
    t0 = time.monotonic()
    tp = phase_tp(dev)
    emit("tp", seconds=time.monotonic() - t0, **tp)
    from repro_torch.configs import get_config
    serve_cfg = get_config(SERVE_ARCH)
    serve_hd = (serve_cfg.reduced() if SERVE_REDUCED else serve_cfg).head_dim
    serve_kernels = []
    for name, src, replaces, pick in (
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:74",
             lambda r: r["shape"].startswith(
                 f"B={SERVE_BATCH} S={SERVE_PROMPT} ")
             and r["head_dim"] == serve_hd),
            ("decode_attention", "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:61",
             lambda r: r.get("length") == DECODE_LENGTHS[2])):
        mine = [r for r in attn_rows + zoo_rows + fam_rows + enc_rows
                if r["kernel"] == name]
        main_row = next(r for r in attn_rows if r["kernel"] == name
                        and r["dtype"] == "bfloat16" and pick(r))
        # the zoo's head shapes at the serve's prefill and mean decode
        # length, bfloat16
        zoo = [{k: r[k] for k in ("shape", "group", "kernel_route", "ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "call_ms", "max_abs_err")}
               for r in zoo_rows if r["kernel"] == name
               and r["dtype"] == "bfloat16" and pick(r)]
        serve_kernels.append({
            "name": name, "route": "cuda",
            "kernel_route": main_row["kernel_route"],
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": timed["launches"][name],
            **({"launches_by_route": timed["launches_by_route"][name]}
               if name in timed["launches_by_route"] else {}),
            "launches_by_path": {
                SERVE_ARCH: timed["launches"][name],
                **{a: z["launches"][name]
                   for a, z in {**zoo_serves, **fam_serves}.items()},
                ENC_ARCH: enc_timed["launches"][name],
                "dryrun": dryrun_launches(dry, name),
                f"{TP_ARCH} tp (1, 1)": tp["serve"]["launches"][name],
                **tp_launches(tp, name)},
            # the decode kernel with its log-sum-exp (the partitioned
            # decode's route) beside the launch without it, bfloat16
            **({"lse_shapes": [r for r in tp["lse"]
                               if r["dtype"] == "bfloat16"],
                "lse_launches": tp["serve"]["launches"][
                    "decode_attention_lse"] + sum(tp_launches(
                        tp, "decode_attention_lse").values())}
               if name == "decode_attention" else {}),
            # one (16, 16) rank's shapes of the dry-run cells
            "tp_rank_shapes": tp_rank_shapes(tp, name),
            "max_abs_err": max(r["max_abs_err"] for r in mine
                               if r["dtype"] == "bfloat16"),
            "max_abs_err_float32": max(r["max_abs_err"] for r in mine
                                       if r["dtype"] == "float32"),
            **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "call_ms")},
            "shape": main_row["shape"] + " bfloat16 (the serve's "
                     + ("prefill" if name == "flash_attention" else
                        "mean decode length") + ")",
            "zoo_shapes": zoo,
            # the VLM's G = 8 and the hybrid's D = 112, bfloat16: each
            # serve's prefill and mean decode length, and D = 112's tails
            "family_shapes": [
                {k: r[k] for k in ("arch", "shape", "group", "head_dim",
                                   "kernel_route", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "call_ms", "max_abs_err")}
                for r in fam_rows if r["kernel"] == name
                and r["dtype"] == "bfloat16" and (
                    name == "flash_attention" or r["length"] == dict(
                        (a, p + FAM_GEN // 2)
                        for a, _, p in FAM_SERVE)[r["arch"]])],
            # the enc-dec serve's, bfloat16: flash full over the encoder's
            # frames, cross (Sq != Sk) and causal over the decoder's
            # tokens; decode over the cross cache (length = S_max) and the
            # decoder's cache at its mean length
            "encdec_shapes": [
                {k: r[k] for k in ("arch", "path", "shape", "group",
                                   "head_dim", "kernel_route", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "call_ms", "max_abs_err")}
                for r in enc_rows if r["kernel"] == name
                and r["dtype"] == "bfloat16" and (
                    name == "flash_attention" or r["path"] == "cross"
                    or r["length"] == max(1, ENC_PROMPT // 8)
                    + ENC_GEN // 2)],
            # the dry-run's cut cells: 32k and 500k rows
            "dryrun_shapes": dryrun_shapes(dry, name)})

    # the main path's kernel work: one characterize sweep and one re-sweep
    main = [r for r in rows if r["case"] in ("characterize", "resweep")]
    big = max(main, key=lambda r: r["payload_mb"])
    print(json.dumps({"kernels": [{
        "name": "frame_knob_grid", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/frame_knob_grid.cu",
        "replaces": "src/repro/kernels/frame_knobs.py:438",
        "launches": main_launches,
        "launches_by_path": {"closed_loop": main_launches,
                             "scenario": scen["launches"]},
        "max_abs_err": max(worst[0], scen["kernel"]["max_abs_err"]),
        "mismatch_fraction": max(worst[1],
                                 scen["kernel"]["mismatch_fraction"]),
        "ms": sum(r["ms"] for r in main),
        "call_ms": sum(r["call_ms"] for r in main),
        "traced_ms": sum(r["traced_ms"] for r in main),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": sum(r["bound_ms"] for r in main),
        "bound_by": max(("bytes", "operations"), key=lambda k: sum(
            r["bound_ms"] for r in main if r["bound_by"] == k)),
        "library_ms": None,
        "shape": f"the main path's 30 calls at 1080x1920, knob4 on: 15 "
                 f"groups x 16 frames (characterize) + 15 groups x 32 "
                 f"frames (re-sweep); largest group "
                 f"{big['ms']:.3f} ms (call {big['call_ms']:.3f} ms) vs "
                 f"bound {big['bound_ms']:.3f} ms",
        # the scenario path's own launches at 144x256, checked and timed
        "scenario_path": scen["kernel"]},
        *serve_kernels, dict(wkv_kernel, launches_by_path={
            RWKV_ARCH: wkv_kernel["launches"],
            "dryrun": dryrun_launches(dry, "wkv_linear_scan"),
            **tp_launches(tp, "wkv_linear_scan")},
            dryrun_shapes=dryrun_shapes(dry, "wkv_linear_scan"),
            tp_rank_shapes=tp_rank_shapes(tp, "wkv_linear_scan")),
        *quant_kernel_rows(quant, train_run, {
            **families, f"{REMAT_ARCH} remat=dots": remat["train_step"],
            f"{TRAIN_ARCH} mesh (1, 1)": mesh["train"]}),
        knobs_row]}),
        flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
