"""The port's host pipeline pieces of the camera path
(``repro_torch.data.pipeline``: ``CameraBatcher``, ``BackupFetcher``) and
the v1 compatibility surface (``repro_torch.compat.subscribe_v1``) against
the JAX package's.

Tolerance: none.  ``CameraBatcher`` is host NumPy in both packages, so the
model batches are held exactly equal (shapes, dtypes and values), on a
scripted sequence with dropped frames and ragged knob-resized shapes and on
the frames a 144x256 port system delivers.  ``BackupFetcher`` is held to
the same hedging counts as JAX's under one deterministic slow fetch: the
first call for every fifth index sleeps 1 s and every other call 20 ms, so
each straggler is hedged once and its backup wins (a 20 ms fetch would have
to take three times the p95 of the ones before it to hedge by mistake).
``subscribe_v1`` must deliver the same timestamps as the port's own
``EdgeBroker.subscribe`` and warn nothing.
"""

import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import compat  # noqa: E402
from repro_torch.core.api import (DeliveredFrame,  # noqa: E402
                                  LatencyBreakdown, SubscribeSpec)
from repro_torch.core.broker import MezSystem  # noqa: E402
from repro_torch.core.channel import calibrated_channel  # noqa: E402
from repro_torch.core.characterization import (  # noqa: E402
    characterize, fit_latency_regression)
from repro_torch.data.camera import CameraConfig, SyntheticCamera  # noqa: E402
from repro_torch.data.pipeline import BackupFetcher, CameraBatcher  # noqa: E402


@pytest.fixture
def jp():
    pytest.importorskip("jax")
    from repro.data import pipeline
    return pipeline


def scripted_frames() -> list[DeliveredFrame]:
    """Delivered frames of three shapes (one full, two knob-resized) with
    every fourth one dropped (``frame=None``)."""
    rng = np.random.default_rng(0)
    shapes = [(12, 16, 3), (8, 10, 3), (12, 16, 3), (6, 16, 3)]
    out = []
    for i in range(23):
        frame = (None if i % 4 == 3 else
                 rng.integers(0, 256, shapes[i % 4], dtype=np.uint8))
        out.append(DeliveredFrame(camera_id=f"cam{i % 2}", timestamp=i / 5,
                                  frame=frame, wire_bytes=100 + i,
                                  latency=LatencyBreakdown(network=0.01),
                                  knob_index=i % 3))
    return out


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("batch", [1, 3, 5])
def test_camera_batcher_push_matches_jax(jp, batch):
    mine, theirs = CameraBatcher(batch), jp.CameraBatcher(batch)
    got, want = [], []
    for d in scripted_frames():
        for out, b in ((got, mine.push(d)), (want, theirs.push(d))):
            if b is not None:
                out.append(b)
    assert len(got) == (23 - 5) // batch
    assert_batches_equal(got, want)


@pytest.mark.parametrize("batch", [2, 4])
def test_camera_batcher_push_batch_matches_jax(jp, batch):
    """Whole ``FrameBatch``-like units, each of which may complete none or
    several model batches."""
    frames = scripted_frames()
    units = [frames[i:i + 7] for i in range(0, len(frames), 7)]
    mine, theirs = CameraBatcher(batch), jp.CameraBatcher(batch)
    got = [b for u in units for b in mine.push_batch(u)]
    want = [b for u in units for b in theirs.push_batch(u)]
    assert_batches_equal(got, want)


def straggler_fetch():
    """fetch(i): the first call for every fifth index takes 1 s, every
    other call 20 ms (so a hedge of a straggler always wins)."""
    seen = set()

    def fetch(i):
        slow = i % 5 == 4 and i not in seen
        seen.add(i)
        time.sleep(1.0 if slow else 0.02)
        return i
    return fetch


def test_backup_fetcher_hedges_like_jax(jp):
    counts = []
    for cls in (BackupFetcher, jp.BackupFetcher):
        bf = cls(straggler_fetch(), hedge_factor=3.0, min_history=4)
        assert [bf.fetch(i) for i in range(15)] == list(range(15))
        counts.append((bf.hedges_issued, bf.hedges_won))
    assert counts[0] == counts[1] == (3, 3)


def test_backup_fetcher_no_hedge_before_history():
    bf = BackupFetcher(straggler_fetch(), min_history=8)
    assert [bf.fetch(i) for i in range(5)] == list(range(5))
    assert bf.hedges_issued == 0


# -- the v1 surface --------------------------------------------------------


@pytest.fixture(scope="module")
def table():
    return characterize(lambda: SyntheticCamera(CameraConfig(
        dynamics="medium", seed=7)), clip_len=4, device="cpu")


def build_system(table, *, frames=6):
    """A one-camera 144x256 port system, wired as tests/test_session.py
    wires the JAX one."""
    ch = calibrated_channel(seed=3)
    system = MezSystem(ch, device="cpu")
    sizes = np.linspace(table.sizes_sorted[0], table.sizes_sorted[-1], 12)
    reg = fit_latency_regression(sizes, ch.regression_points(sizes, n=1))
    cam = system.add_camera("cam0")
    src = SyntheticCamera(CameraConfig(camera_id="cam0", dynamics="medium",
                                       seed=7))
    cam.background = src.background
    cam.set_target(0.100, 0.90, table, reg)
    for ts, f, _ in src.stream(frames):
        cam.publish(ts, f)
    return system


def test_v1_iterator_warns_and_compat_module_does_not(table):
    spec = SubscribeSpec("app", "cam0", 0.0, 100.0, 0.1, 0.9)
    with pytest.warns(DeprecationWarning,
                      match="repro_torch.compat.subscribe_v1"):
        old = [d.timestamp for d in build_system(table).edge.subscribe(spec)]
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        new = [d.timestamp for d in
               compat.subscribe_v1(build_system(table), spec)]
    assert old == new and len(new) == 6


def test_delivered_frames_batch_like_jax(jp, table):
    """The path's end: frames a port subscription delivers become the same
    model batches in both packages' batchers."""
    spec = SubscribeSpec("app", "cam0", 0.0, 100.0, 0.1, 0.9)
    delivered = list(compat.subscribe_v1(build_system(table), spec))
    assert any(d.frame is not None for d in delivered)
    mine, theirs = CameraBatcher(2), jp.CameraBatcher(2)
    got = [b for d in delivered if (b := mine.push(d)) is not None]
    want = [b for d in delivered if (b := theirs.push(d)) is not None]
    assert got
    assert_batches_equal(got, want)
