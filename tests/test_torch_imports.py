"""Package boundaries of the port: ``repro_torch`` imports neither ``jax`` nor
anything of ``repro`` (nor ``ml_dtypes``, which the card's machine lacks);
its entry points run on CUDA unless asked for the CPU, and raise without a
CUDA device instead of carrying on elsewhere."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.core import api as TA  # noqa: E402
from repro_torch.core import approx_comm as TAC  # noqa: E402
from repro_torch.core import characterization as TCh  # noqa: E402
from repro_torch.core import controller as TC  # noqa: E402
from repro_torch.core import drift as TD  # noqa: E402
from repro_torch.core import grid_engine as TG  # noqa: E402
from repro_torch.core import log as TL  # noqa: E402
from repro_torch.core import federation as TF  # noqa: E402
from repro_torch.core import scenario as TS  # noqa: E402
from repro_torch.core.broker import MezSystem  # noqa: E402
from repro_torch.core.channel import calibrated_channel  # noqa: E402
from repro_torch.data.camera import CameraConfig, SyntheticCamera  # noqa: E402
from repro_torch.kernels import frame_knobs as FK  # noqa: E402
from repro_torch.kernels import linear_scan as LS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import rwkv6 as TR  # noqa: E402
from repro_torch.models.registry import build_model, make_batch  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for name in {port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_source_has_no_jax_or_repro_import(path):
    bad = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)
    assert not bad.findall(path.read_text())


def test_imports_without_ml_dtypes():
    """bfloat16 leaves cross to NumPy as uint16 bits: nothing of the port
    needs ``ml_dtypes``, which the card's machine does not have."""
    code = (
        "import importlib, sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"for name in {port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    bad = re.compile(r"^\s*(from|import)\s+ml_dtypes(\.|\s|$)", re.M)
    assert not any(bad.findall(p.read_text()) for p in PKG.rglob("*.py"))


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")


def _camera():
    return SyntheticCamera(CameraConfig(dynamics="simple", seed=1))


ENTRY_POINTS = {
    "run_grid": lambda: TG.run_grid(_camera().background,
                                    [_camera().next_frame()[1]]),
    "refresh_tables": lambda: TG.refresh_tables(
        _camera().background, [_camera().next_frame()[1]] * 4),
    "characterize": lambda: TCh.characterize(_camera, clip_len=2,
                                             engine="batched"),
    "MezSystem": lambda: MezSystem(calibrated_channel(seed=0)),
    "FederatedMezSystem": lambda: TF.FederatedMezSystem(
        calibrated_channel(seed=0)),
    "BrokerHerd": lambda: TF.BrokerHerd(2),
    "run_scenario": lambda: TS.run_scenario(TS.ScenarioSpec(name="s")),
    "DriftMonitor": lambda: TD.DriftMonitor(["cam0"]),
    "ControllerTables": lambda: TC.ControllerTables.from_arrays(
        np.ones(3), np.ones(3), np.arange(3)),
    "frame_knob_grid": lambda: FK.frame_knob_grid(
        torch.zeros((1, 4, 4, 3), dtype=torch.uint8),
        torch.zeros((1, 4, 4, 3), dtype=torch.uint8),
        FK.build_transform_plan(4, 4, scale=1.0, cs=0, blur_ks=(0,))),
    "serve": lambda: serve("qwen3-1.7b", batch=1, prompt_len=4, gen=1),
    "Model.init_params": lambda: build_model(
        get_config("qwen3-1.7b").reduced()).init_params(torch.Generator()),
    "Model.init_cache": lambda: build_model(
        get_config("qwen3-1.7b").reduced()).init_cache(1, 4),
    "make_batch": lambda: make_batch(get_config("qwen3-1.7b").reduced(), 1,
                                     4, generator=torch.Generator()),
    "model_params_from_numpy": lambda: convert.model_params_from_numpy(
        get_config("qwen3-1.7b").reduced(), _zeros_tree(param_shapes(
            get_config("qwen3-1.7b").reduced()))),
    "serve rwkv6": lambda: serve("rwkv6-1.6b", batch=1, prompt_len=4, gen=1),
    "rwkv6.init_params": lambda: TR.init_params(
        torch.Generator(), get_config("rwkv6-1.6b").reduced()),
    "rwkv6.init_cache": lambda: TR.init_cache(
        get_config("rwkv6-1.6b").reduced(), 1, 4),
    "train": lambda: train("qwen3-1.7b", steps=1, batch=1, seq=8),
    "init_opt_state": lambda: init_opt_state({"w": torch.zeros(3)}),
    "Checkpointer.restore": lambda: _restore_without_device(),
    "CollectiveController": lambda: TAC.CollectiveController(
        4e6, {16: 1.0, 8: 0.999, 4: 0.985}, latency_target=0.002,
        slope=1 / 3e9),
    "opt_state_from_numpy": lambda: convert.opt_state_from_numpy(
        get_config("qwen3-1.7b").reduced(), {
            "m": _zeros_tree(param_shapes(get_config("qwen3-1.7b")
                                          .reduced())),
            "v": _zeros_tree(param_shapes(get_config("qwen3-1.7b")
                                          .reduced())),
            "count": np.zeros((), np.int32)}),
    "rwkv_state_from_numpy": lambda: convert.rwkv_state_from_numpy(
        wkv=np.zeros((2, 1, 4, 16, 16), np.float32),
        shift_tm=np.zeros((2, 1, 64), np.float32),
        shift_cm=np.zeros((2, 1, 64), np.float32), length=0),
    "frame_log_init": lambda: TL.frame_log_init(4, (2, 2, 3)),
    "frame_log_from_numpy": lambda: convert.frame_log_from_numpy(
        timestamps=np.full(4, -np.inf, np.float32),
        payload=np.zeros((4, 2, 2, 3), np.uint8), head=np.int32(0),
        count=np.int32(0), last_ts=np.float32(-np.inf),
        rejects=np.int32(0)),
    "ops.frame_knobs": lambda: ops.frame_knobs(
        np.zeros((1, 4, 4), np.uint8), np.zeros((1, 4, 4), np.uint8)),
    "ops.quantize_blocks": lambda: ops.quantize_blocks(
        np.zeros((4, 8), np.float32)),
}


def _restore_without_device():
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(1, {"w": torch.zeros(3)})
        ck.restore({"w": torch.zeros(3)})


def _zeros_tree(shapes):
    return {k: _zeros_tree(v) if isinstance(v, dict)
            else np.zeros(v, np.float32) for k, v in shapes.items()}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_cuda_or_an_explicit_cpu(no_cuda, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()


def test_serve_runs_on_the_cpu_when_asked():
    out = serve("qwen3-1.7b", batch=2, prompt_len=6, gen=2, device="cpu")
    assert out["tokens"].shape == (2, 3) and out["cache_len"] == 8


def test_rwkv_serve_runs_on_the_cpu_when_asked():
    out = serve("rwkv6-1.6b", batch=2, prompt_len=6, gen=2, device="cpu")
    assert out["tokens"].shape == (2, 3) and out["cache_len"] == 8


def test_train_runs_on_the_cpu_when_asked():
    out = train("qwen3-1.7b", steps=2, batch=2, seq=16, device="cpu")
    assert out["device"] == "cpu" and len(out["losses"]) == 2


def test_wkv_kernel_route_raises_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a CUDA device never takes the plain
    route under ``impl="kernel"``: the wrapper raises."""
    x = torch.zeros((1, 1, 1, 16), device="meta")
    with pytest.raises(RuntimeError, match="one CUDA device"):
        LS.wkv(x, x, x, x, torch.zeros((1, 16), device="meta"),
               impl="kernel")


def test_frame_knobs_raises_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a CUDA device never takes the plain
    route of the knob kernel: the wrapper raises."""
    x = torch.zeros((1, 4, 4), device="meta")
    with pytest.raises(RuntimeError, match="one CUDA device"):
        FK.frame_knobs(x, x)
    with pytest.raises(RuntimeError, match="one CUDA device"):
        ops.frame_knobs(x, x, blur_k=1)


def test_mesh_is_not_ported():
    system = MezSystem(calibrated_channel(seed=0), device="cpu")
    system.add_camera("cam0")
    sess = system.edge.open_session("app")
    spec = TA.SubscribeSpec("app", "cam0", 0.0, 1.0, 0.1, 0.9)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1, fleet mesh and sharding"):
        system.edge.create_subscription(
            sess, (spec,), options=TA.SubscriptionOptions(fleet=True, mesh=1))
