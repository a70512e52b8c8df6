"""``examples/torch_train_100m.py`` against its JAX namesake,
``examples/train_100m.py``: the same configuration, field for field and
in ``param_count()``, and its ``main`` run end to end on the CPU at a
small batch (the loss must fall, as the JAX example asserts)."""

import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def example():
    return load("torch_train_100m")


def test_config_matches_the_jax_example(example):
    pytest.importorskip("jax")
    want = load("train_100m").build_100m_config()
    got = example.build_100m_config()
    shared = ({f.name for f in dataclasses.fields(got)}
              & {f.name for f in dataclasses.fields(want)})
    assert len(shared) > 30
    for name in sorted(shared):
        assert getattr(got, name) == getattr(want, name), name
    assert got.param_count() == want.param_count()
    assert (got.name, got.num_layers, got.d_model, got.vocab_size,
            got.remat) == ("qwen3-100m", 12, 512, 32000, "none")


def test_main_trains_on_the_cpu(example, tmp_path):
    from repro_torch.configs import ARCHS
    try:
        out = example.main(["--steps", "4", "--batch", "1", "--seq", "32",
                            "--device", "cpu", "--ckpt", str(tmp_path)])
        assert "qwen3-100m" in ARCHS        # registered for the launcher
    finally:
        ARCHS.pop("qwen3-100m", None)
    assert out["device"] == "cpu" and len(out["losses"]) == 4
    assert out["final_loss"] < out["first_loss"]
