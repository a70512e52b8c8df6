"""The slice as a whole: the Mez closed loop (publish -> control -> fetch ->
session) in both packages from one and the same characterization.

One JAX-side table is carried across with ``repro_torch.convert``; three
cameras publish ten frames each into systems wired alike; one session
subscribes all three, tightens its latency bound after the second poll and
polls until drained, on the host control path and on the fused fleet tick.
The delivered sequence of (camera, timestamp, setting, wire bytes, latency)
and the event stream must be identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import api as JA  # noqa: E402
from repro.core.broker import MezSystem as JaxMezSystem  # noqa: E402
from repro.core.channel import calibrated_channel as jax_channel  # noqa: E402
from repro.core.characterization import characterize  # noqa: E402
from repro.core.characterization import fit_latency_regression  # noqa: E402
from repro.core.session import MezClient as JaxClient  # noqa: E402
from repro.data.camera import CameraConfig, SyntheticCamera  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api as TA  # noqa: E402
from repro_torch.core.broker import MezSystem  # noqa: E402
from repro_torch.core.channel import calibrated_channel  # noqa: E402
from repro_torch.core.session import MezClient  # noqa: E402
from repro_torch.data.camera import CameraConfig as TCameraConfig  # noqa: E402
from repro_torch.data.camera import SyntheticCamera as TCamera  # noqa: E402

N_CAMS, FRAMES = 3, 10


@pytest.fixture(scope="module")
def jax_table():
    return characterize(
        lambda: SyntheticCamera(CameraConfig(dynamics="medium", seed=7)),
        clip_len=8)


def port_table(t):
    p = t.proxy
    return convert.table_from_numpy(
        settings=[dataclasses.astuple(s) for s in t.settings],
        sizes_sorted=t.sizes_sorted, best_acc=t.best_acc,
        best_idx=t.best_idx, acc_by_setting=t.acc_by_setting,
        size_by_setting=t.size_by_setting,
        proxy_coeffs=None if p is None else p.coeffs,
        proxy_median_rel_err=0.0 if p is None else p.median_rel_err,
        proxy_max_rel_err=0.0 if p is None else p.max_rel_err,
        min_accuracy=t.min_accuracy, source=t.source, activity=t.activity,
        residual_spread=t.residual_spread)


def build(jax_side, table):
    """``MezSystem`` of either package, wired like tests/test_session.py."""
    if jax_side:
        ch = jax_channel(seed=3, workload="jaad")
        system, cam_cls, cfg_cls = JaxMezSystem(ch), SyntheticCamera, \
            CameraConfig
    else:
        ch = calibrated_channel(seed=3, workload="jaad")
        system, cam_cls, cfg_cls = MezSystem(ch, device="cpu"), TCamera, \
            TCameraConfig
    sizes = np.linspace(table.sizes_sorted[0], table.sizes_sorted[-1], 12)
    reg = fit_latency_regression(sizes, ch.regression_points(sizes,
                                                             n=N_CAMS))
    if not jax_side:
        reg = convert.regression_from_numpy(slope=reg.slope,
                                            intercept=reg.intercept)
    for i in range(N_CAMS):
        cam = system.add_camera(f"cam{i}")
        src = cam_cls(cfg_cls(camera_id=f"cam{i}", dynamics="medium",
                              seed=7))
        cam.background = src.background
        cam.set_target(0.100, 0.90, table, reg)
        for ts, f, _ in src.stream(FRAMES):
            cam.publish(ts, f)
    return system


def drain(jax_side, table, fleet):
    system = build(jax_side, table)
    api, client = (JA, JaxClient) if jax_side else (TA, MezClient)
    sess = client(system).open_session("app")
    sub = sess.subscribe([f"cam{i}" for i in range(N_CAMS)], 0.0, 100.0,
                         qos=api.QosBounds(0.100, 0.90),
                         options=api.SubscriptionOptions(fleet=fleet))
    delivered = []
    polls = 0
    while (batch := sub.poll(max_frames=6)):
        polls += 1
        if polls == 2:                  # live renegotiation mid-stream
            sub.update_qos(latency=0.030)
        delivered.extend((d.camera_id, d.timestamp, d.knob_index,
                          d.wire_bytes, d.infeasible, d.latency.total)
                         for d in batch.frames)
    events = [(e.kind.name, e.camera_id, e.timestamp, e.detail)
              for e in sub.events()]
    return delivered, events


@pytest.mark.parametrize("fleet", [False, True], ids=["host", "fleet"])
def test_loop_matches_jax(jax_table, fleet):
    want = drain(True, jax_table, fleet)
    got = drain(False, port_table(jax_table), fleet)
    assert len(got[0]) == N_CAMS * FRAMES
    assert got[0] == want[0]
    assert got[1] == want[1]
    # the controller acted: more than one setting went over the wire
    assert len({k for _, _, k, *_ in got[0]}) > 1
