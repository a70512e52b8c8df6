"""``characterize(engine="batched")`` in the port against the JAX package on
the complex calibration clip, with and without knob4: the same kept
settings and the same accuracies (expected difference 0, bound 0.01), and
two runs of the port give the same table."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.characterization import characterize as jax_characterize  # noqa: E402
from repro.data.camera import CameraConfig as JaxCameraConfig  # noqa: E402
from repro.data.camera import SyntheticCamera as JaxCamera  # noqa: E402
from repro_torch.core.characterization import characterize  # noqa: E402
from repro_torch.data.camera import CameraConfig, SyntheticCamera  # noqa: E402

CLIP_LEN = 8


def codes(table):
    return [(s.resolution, s.colorspace, s.blur, s.artifact, s.diff)
            for s in table.settings]


def port_table(include_artifact):
    return characterize(
        lambda: SyntheticCamera(CameraConfig(dynamics="complex", seed=7)),
        clip_len=CLIP_LEN, include_artifact=include_artifact,
        engine="batched", device="cpu")


@pytest.fixture(scope="module")
def port_tables():
    return {False: port_table(False), True: port_table(True)}


@pytest.mark.parametrize("include_artifact", [False, True],
                         ids=["noart", "art"])
def test_characterize_matches_jax(port_tables, include_artifact):
    want = jax_characterize(
        lambda: JaxCamera(JaxCameraConfig(dynamics="complex", seed=7)),
        clip_len=CLIP_LEN, include_artifact=include_artifact,
        engine="batched")
    got = port_tables[include_artifact]
    assert codes(got) == codes(want)
    assert len(got.settings) > 0
    np.testing.assert_allclose(got.acc_by_setting, want.acc_by_setting,
                               rtol=0, atol=0.01)
    np.testing.assert_array_equal(got.best_idx, want.best_idx)
    # table sizes are clip medians of calibrated proxy sizes
    np.testing.assert_allclose(got.size_by_setting, want.size_by_setting,
                               rtol=2e-3)
    assert got.activity == pytest.approx(want.activity, abs=0)
    assert got.min_accuracy == want.min_accuracy
    assert got.includes_artifact == want.includes_artifact


def test_characterize_is_deterministic(port_tables):
    a, b = port_tables[False], port_table(False)
    assert codes(a) == codes(b)
    np.testing.assert_array_equal(a.acc_by_setting, b.acc_by_setting)
    np.testing.assert_array_equal(a.size_by_setting, b.size_by_setting)
    np.testing.assert_array_equal(a.sizes_sorted, b.sizes_sorted)
    assert a.residual_spread == b.residual_spread
