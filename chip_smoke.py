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
                (one ``nvcc`` per source, all started together) and load it;
  kernel        every (resolution, colorspace) group at 1080x1920 in three
                cases -- 16 frames without knob4, 16 frames with knob4
                (characterize's shape) and the live re-sweep's own 32-frame
                input with knob4: the kernel against its plain PyTorch
                version on the same inputs (payload within one grey level on
                at most 1e-3 of the bytes, ``changed`` exact, features
                within 1e-3 relative plus what the differing bytes can move,
                and those of the payload produced), timed with CUDA events;
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
  profile       device time per activity of the kernel's largest group.

Then a ``kernels`` line (every kernel: launches on the main path, error
against its plain version, its time beside its bound and the plain
version's), the card's ``name, power.limit``, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line; without a CUDA device, or outside a checkout, it exits 2.
"""

from __future__ import annotations

import json
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
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
PAYLOAD_TOL, MISMATCH_TOL, FEAT_RTOL = 1, 1e-3, 1e-3


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


def phase_kernel(dev):
    """Every group in three cases, kernel against plain, and the times of
    both beside the bound.  ``check``: 15 frames of the complex camera,
    no knob4 (F=16).  ``characterize``: the same frames with knob4 (F=16,
    15 settings), the shape of ``characterize(include_artifact=True)``.
    ``resweep``: the live re-sweep's own inputs -- cam0's background and
    its 16-frame log tail, padded to F=32, with knob4 (the live table keeps
    knob4 settings).  Returns (rows, worst error)."""
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
                ms = cuda_ms(lambda: FK.frame_knob_grid(
                    frames, prev, plan, device=dev, **kw), REPS)
                plain = cuda_ms(lambda: FK.frame_knob_grid_plain(
                    frames, prev, plan, **kw), REPS)
                b_ms, b_by = bound_ms(plan, n, art != (0,))
                row = dict(case=case, frames=n, res=res, cs=cs,
                           knob4=art != (0,), settings=plan.n_settings,
                           payload_mb=plan.n_settings * n
                           * plan.payload_bytes / 1e6,
                           max_abs_err=max_d, mismatch=frac, ms=ms,
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
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, end = 0, None
    for s, e in spans:
        if end is None or s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9, len(spans)


def phase_profile(dev) -> list[dict]:
    """Device time per activity (kernel, copy, memset) of a
    ``frame_knob_grid`` call in its largest group (BGR, full resolution,
    knob4: 15 settings x 16 frames), traced with ``torch.profiler`` over
    ``REPS`` calls."""
    import torch
    from repro_torch.configs.mez_edge import CONFIG
    from repro_torch.core import knobs as K
    from repro_torch.data.camera import CameraConfig, SyntheticCamera
    from repro_torch.kernels import frame_knobs as FK
    cam = SyntheticCamera(CameraConfig(height=H, width=W, dynamics="complex",
                                       seed=CONFIG.seed))
    frames, prev, bg, enable = grid_inputs(
        dev, cam.background,
        [cam.next_frame()[1] for _ in range(FRAME_BUCKET - 1)])
    plan = FK.build_transform_plan(H, W, scale=1.0, cs=FK.CS_BGR,
                                   blur_ks=K.BLUR_KERNELS,
                                   art_modes=(0, 1, 2))

    def call():
        return FK.frame_knob_grid(frames, prev, plan, background=bg,
                                  art_enable=enable, device=dev)

    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(REPS):
            call()
        torch.cuda.synchronize()
    per = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            t = per.setdefault(e.name(), [0, 0.0])
            t[0] += 1
            t[1] += (e.end_ns() - e.start_ns()) / 1e6
    # each grid call launches each activity once, but the trace may not
    # record every launch: average over the launches it did record
    return [{"activity": k, "recorded": c, "ms_per_launch": ms / c}
            for k, (c, ms) in sorted(per.items(), key=lambda kv: -kv[1][1])]


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found -- run from the root "
              "of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the plain version's and the torch-op stages' f32 must stay f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    run(torch.device("cuda"))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev) -> None:
    """Every phase on ``dev``; raises on any failure."""
    import torch
    t0 = time.monotonic()
    from repro_torch.kernels import build
    from repro_torch.kernels import frame_knobs as FK
    paths = build.build()
    FK._load_lib()
    ptxas = [ln.strip() for pth in paths.values()
             for ln in Path(str(pth) + ".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.monotonic() - t0, kernels=sorted(paths),
         ptxas=ptxas)

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
    sums = {case: {k: sum(r[k] for r in rows if r["case"] == case)
                   for k in ("ms", "plain_ms", "bound_ms")}
            for case in ("check", "characterize", "resweep")}
    emit("kernel", seconds=time.monotonic() - t0, groups=len(rows),
         max_abs_err=worst[0], max_mismatch=worst[1], per_case=sums)

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
    stages = phase_profile(dev)
    emit("profile", seconds=time.monotonic() - t0,
         group="res 0, BGR, knob4, 15 settings x 16 frames", stages=stages)

    # the main path's kernel work: one characterize sweep and one re-sweep
    main = [r for r in rows if r["case"] in ("characterize", "resweep")]
    big = max(main, key=lambda r: r["payload_mb"])
    print(json.dumps({"kernels": [{
        "name": "frame_knob_grid", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/frame_knob_grid.cu",
        "replaces": "src/repro/kernels/frame_knobs.py:364",
        "launches": main_launches, "max_abs_err": worst[0],
        "mismatch_fraction": worst[1],
        "ms": sum(r["ms"] for r in main),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": sum(r["bound_ms"] for r in main),
        "bound_by": max(("bytes", "operations"), key=lambda k: sum(
            r["bound_ms"] for r in main if r["bound_by"] == k)),
        "library_ms": None,
        "shape": f"the main path's 30 calls at 1080x1920, knob4 on: 15 "
                 f"groups x 16 frames (characterize) + 15 groups x 32 "
                 f"frames (re-sweep); largest group "
                 f"{big['ms']:.3f} ms vs bound {big['bound_ms']:.3f} ms"}]}),
        flush=True)


if __name__ == "__main__":
    sys.exit(main())
