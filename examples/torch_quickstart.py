"""Quickstart on PyTorch: the Mez loop in ~60 lines, on the v2 session API.

Five cameras publish to Mez under 4-peer interference; one subscriber opens
a session, asks for (100 ms, 95%) bounds, and drains timestamp-merged
``FrameBatch`` units; the latency controller holds the SLO by adapting frame
quality.  The knob-grid sweep runs the ``frame_knob_grid`` kernel on the
card.  Run:

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs.mez_edge import CONFIG as EDGE
from repro_torch.core.api import QosBounds
from repro_torch.core.broker import MezSystem
from repro_torch.core.channel import calibrated_channel
from repro_torch.core.characterization import (characterize,
                                               fit_latency_regression)
from repro_torch.core.session import MezClient
from repro_torch.data.camera import CameraConfig, SyntheticCamera
from repro_torch.device import resolve_device


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    device = resolve_device(ap.parse_args().device)
    print(f"device: {device}")
    # 1. offline characterization (paper Section 2): knob grid -> (size, F1)
    print("characterizing knob grid on a calibration clip ...")
    table = characterize(
        lambda: SyntheticCamera(CameraConfig(dynamics="complex",
                                             seed=EDGE.seed)),
        clip_len=16, device=device)
    print(f"  kept {len(table.settings)} knob settings, "
          f"sizes {table.sizes_sorted[0]/1e3:.1f}..".rstrip("."))

    # 2. deployment: 5 cameras on one contended 802.11ac channel
    channel = calibrated_channel(seed=3, workload="jaad")
    system = MezSystem(channel, device=device)
    sizes = np.linspace(table.sizes_sorted[0], table.sizes_sorted[-1], 16)
    regression = fit_latency_regression(
        sizes, channel.regression_points(sizes, n=EDGE.num_cameras))
    for i in range(EDGE.num_cameras):
        cam = system.add_camera(f"cam{i}")
        src = SyntheticCamera(CameraConfig(camera_id=f"cam{i}",
                                           dynamics="complex", seed=EDGE.seed))
        cam.background = src.background
        cam.set_target(EDGE.latency_target, EDGE.accuracy_target,
                       table, regression)
        for ts, frame, _ in src.stream(40):
            cam.publish(ts, frame)                       # Publish API

    # 3. open a session, subscribe with latency + accuracy bounds
    client = MezClient(system)
    print(f"cameras: {client.get_camera_info()}")        # GetCameraInfo API
    latencies, wires = [], []
    with client.open_session("app0") as session:
        sub = session.subscribe("cam0", 0.0, 8.0,
                                qos=QosBounds(EDGE.latency_target,
                                              EDGE.accuracy_target))
        while (batch := sub.poll(max_frames=EDGE.fetch_window)):
            for d in batch.delivered:                    # knob5 drops excluded
                latencies.append(d.latency.total)
                wires.append(d.wire_bytes)
        for ev in sub.events():                          # out-of-band failures
            print(f"  event: {ev.kind.value} on {ev.camera_id}")
        print(f"  subscription state: {sub.state.value}")
        sub.close()                                      # idempotent
    lat = np.asarray(latencies)
    print(f"delivered {len(lat)} frames")
    print(f"  p95 latency {np.percentile(lat, 95)*1e3:.0f} ms "
          f"(target {EDGE.latency_target*1e3:.0f} ms)")
    print(f"  settled p95 {np.percentile(lat[10:], 95)*1e3:.0f} ms")
    print(f"  median wire size {np.median(wires)/1e3:.0f} kB "
          f"(raw ~90 kB)")


if __name__ == "__main__":
    main()
