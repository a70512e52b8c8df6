"""The port's batched characterization engine against the JAX package on the
CPU: the device stages (``_change_counts``, ``_label_group``) exactly, and a
whole ``run_grid`` sweep against ``repro.core.grid_engine.run_grid`` with
the XLA path (``use_pallas=False``).

The two sweeps' payloads agree to one grey level on a few bytes in 1e4
(their operator products sum in different orders); ``run_grid`` turns those
bytes into detector diffs and calibrated proxy sizes, so box lists are held
identical on all but 1% of (combo, frame) pairs and the per-combo median
sizes -- what a table keeps -- to 2e-3 relative (ROADMAP Queue 3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import grid_engine as JG  # noqa: E402
from repro.data.camera import CameraConfig, SyntheticCamera  # noqa: E402
from repro_torch.core import grid_engine as TG  # noqa: E402


@pytest.fixture(scope="module")
def clip():
    cam = SyntheticCamera(CameraConfig(dynamics="complex", seed=7))
    bg = cam.background
    return bg, [cam.next_frame()[1] for _ in range(6)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_change_counts_exact(clip, seed):
    rng = np.random.default_rng(seed)
    _, frames = clip
    stack = np.stack(frames).astype(np.int16)
    stack = np.clip(stack + rng.integers(-12, 13, stack.shape), 0,
                    255).astype(np.uint8)
    want = np.asarray(JG._change_counts(jnp.asarray(stack)))
    got = TG._change_counts(torch.as_tensor(stack)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_label_group_exact(seed):
    rng = np.random.default_rng(seed)
    s, f, gh, gw = 3, 4, 36, 64
    diff = rng.gamma(2.0, 8.0, (s, f, gh, gw)).astype(np.float32)
    # a few large blobs that need many propagation rounds
    for i in range(s):
        for j in range(f):
            y, x = rng.integers(0, gh - 12), rng.integers(0, gw - 20)
            diff[i, j, y:y + 12, x:x + 20] += 60.0
    eff = rng.uniform(20.0, 40.0, (s, f)).astype(np.float32)
    want = np.asarray(JG._label_group(jnp.asarray(diff), jnp.asarray(eff)))
    got = TG._label_group(torch.as_tensor(diff), torch.as_tensor(eff)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_run_grid_matches_jax(clip):
    """knob4 sweeps are held end to end by test_torch_characterization."""
    bg, frames = clip
    want = JG.run_grid(bg, frames, use_pallas=False)
    got = TG.run_grid(bg, frames, device="cpu")
    assert got.combos == want.combos
    assert got.pixels == want.pixels and got.zlib_calls == want.zlib_calls
    np.testing.assert_array_equal(got.change_counts, want.change_counts)
    pairs = same = 0
    for combo in want.combos:
        for a, b in zip(got.dets[combo], want.dets[combo]):
            pairs += 1
            same += a.shape == b.shape and np.array_equal(a, b)
        med_g = np.median(got.sizes[combo])
        med_w = np.median(want.sizes[combo])
        assert abs(med_g - med_w) <= 2e-3 * med_w, combo
    assert same >= 0.99 * pairs, (same, pairs)
    # the change matrix drives knob5 with frame_difference's exact walk
    for thresh in (0.0, 0.01, 0.06):
        np.testing.assert_array_equal(got.drop_pattern(thresh),
                                      want.drop_pattern(thresh))
