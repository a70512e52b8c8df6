"""The port's approximate collective (``repro_torch.core.approx_comm``)
against the JAX package's ``core/approx_comm.py`` on the same seeded NumPy
inputs: the quantize round trip and the gradient hook bit for bit (both
packages run the same oracle arithmetic: JAX's ``ref.quantize_ref``, the
port's plain versions), the fidelity characterization within 1e-6 (cosines
summed in another order), the fidelity table equal, the
``CollectiveController``'s decisions identical over the contention
sequence of ``tests/test_runtime.py``, and ``compressed_mean`` on a
one-rank gloo group equal to JAX's one-member ``shard_map``.  One case
runs ``compressed_mean`` across two gloo processes against the formula
``sum_i deq(quant(x_i)) / N``, under hard timeouts so it cannot hang the
suite.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import approx_comm as TAC  # noqa: E402
from repro_torch.core.characterization import LatencyRegression  # noqa: E402
from repro_torch.core.controller import (ControllerConfig,  # noqa: E402
                                         LatencyController)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def draw(shape, *, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import approx_comm as JAC
    return jax, jnp, JAC


def as_jax(jnp, x, dtype):
    xj = jnp.asarray(x)
    return xj.astype(jnp.bfloat16) if dtype == "bf16" else xj


def as_torch(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def to_np(x):
    """A float32 NumPy copy of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(512, 512), (28, 64), (3, 1000),
                                   (2, 256, 512)], ids=str)
def test_quant_roundtrip_matches_jax_bitwise(jx, shape, dtype, bits):
    _, jnp, JAC = jx
    x = draw(shape, seed=1, scale=3e-3)
    want = JAC._quant_roundtrip(as_jax(jnp, x, dtype), bits)
    got = TAC._quant_roundtrip(as_torch(x, dtype), bits)
    assert got.shape == tuple(want.shape)
    assert got.dtype == as_torch(x, dtype).dtype
    np.testing.assert_array_equal(to_np(got), to_np(want))


def test_pad_2d_views_without_padding():
    x = torch.zeros((2, 256, 512))
    x2d, n = TAC._pad_2d(x)
    assert n == x.numel() and x2d.shape == (512, 512)
    assert x2d.data_ptr() == x.data_ptr()
    y2d, m = TAC._pad_2d(torch.ones(1000))
    assert m == 1000 and y2d.shape == (256, 512)
    assert float(y2d.sum()) == 1000.0


def grads_tree():
    return {"embed": draw((512, 64), seed=2, scale=1e-2),
            "layers": {"w": draw((2, 64, 96), seed=3, scale=1e-3),
                       "scale": draw((2, 64), seed=4, scale=1e-4)},
            "small": draw((100,), seed=5)}


@pytest.mark.parametrize("bits", [8, 4, 16])
def test_grad_compressor_hook_matches_jax(jx, bits):
    _, jnp, JAC = jx
    tree = grads_tree()
    want = JAC.make_grad_compressor(bits, min_size=1024)(
        {"embed": jnp.asarray(tree["embed"]),
         "layers": {k: jnp.asarray(v) for k, v in tree["layers"].items()},
         "small": jnp.asarray(tree["small"])})
    got = TAC.make_grad_compressor(bits, min_size=1024)(
        {"embed": torch.from_numpy(tree["embed"]),
         "layers": {k: torch.from_numpy(v)
                    for k, v in tree["layers"].items()},
         "small": torch.from_numpy(tree["small"])})
    for k in ("embed", "small"):
        np.testing.assert_array_equal(to_np(got[k]), to_np(want[k]))
    for k in ("w", "scale"):
        np.testing.assert_array_equal(to_np(got["layers"][k]),
                                      to_np(want["layers"][k]))


def test_characterize_fidelity_matches_jax(jx):
    _, jnp, JAC = jx
    tree = grads_tree()
    want = JAC.characterize_fidelity(
        {"embed": jnp.asarray(tree["embed"]),
         "layers": {k: jnp.asarray(v) for k, v in tree["layers"].items()},
         "small": jnp.asarray(tree["small"])})
    got = TAC.characterize_fidelity(
        {"embed": torch.from_numpy(tree["embed"]),
         "layers": {k: torch.from_numpy(v)
                    for k, v in tree["layers"].items()},
         "small": torch.from_numpy(tree["small"])})
    assert sorted(got) == sorted(want) == [4, 8, 16]
    for bits in want:
        assert abs(got[bits] - want[bits]) <= 1e-6, bits
    assert got[16] == 1.0 and got[16] >= got[8] >= got[4] > 0.95


def test_fidelity_table_matches_jax(jx):
    _, _, JAC = jx
    fid = {16: 1.0, 8: 0.999, 4: 0.985}
    want = JAC.fidelity_table(4e6, fid)
    got = TAC.fidelity_table(4e6, fid)
    for f in ("sizes_sorted", "best_acc", "best_idx", "acc_by_setting",
              "size_by_setting"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.source == want.source and got.min_accuracy == 0.0
    assert TAC.collective_bytes_for(4e6, 8) == \
        JAC.collective_bytes_for(4e6, 8)


GRAD_BYTES, FIDELITY, BW = 4e6, {16: 1.0, 8: 0.999, 4: 0.985}, 3e9


def contention_run(ctl, others=()):
    """``tests/test_runtime.py``'s 60-step sequence: contention x8 on steps
    20-39.  Returns every decision of ``ctl`` and of each of ``others``
    (fed the same latencies)."""
    bits, out = 16, []
    for step in range(60):
        contention = 8.0 if 20 <= step < 40 else 1.0
        lat = (TAC.collective_bytes_for(GRAD_BYTES, bits)
               / (BW / contention) + 1e-4)
        d = ctl.update(lat)
        out.append((d, [o.update(lat) for o in others]))
        bits = d.bits
    return out


def test_collective_controller_matches_jax_and_host(jx):
    _, _, JAC = jx
    target = 1.5 * GRAD_BYTES / BW
    kw = dict(latency_target=target, fidelity_floor=0.98, slope=1.0 / BW)
    port = TAC.CollectiveController(GRAD_BYTES, FIDELITY, device="cpu", **kw)
    ref = JAC.CollectiveController(GRAD_BYTES, FIDELITY, **kw)
    host = LatencyController(
        ControllerConfig(target, 0.98, error_threshold=0.05 * target),
        TAC.fidelity_table(GRAD_BYTES, FIDELITY),
        LatencyRegression(slope=1.0 / BW, intercept=1e-4))
    used = []
    for step, (d, (dj, dh)) in enumerate(contention_run(port, (ref, host))):
        for other in (dj, dh):
            assert d.setting_index == other.setting_index, step
            assert d.acted == other.acted, step
            assert d.feasible == other.feasible, step
        assert d.bits == dj.bits, step
        if d.feasible and d.setting_index >= 0:
            assert FIDELITY[d.bits] >= 0.98
        used.append(d.bits)
    assert min(used[20:40]) < 16       # compressed under contention
    assert used[-1] == 16              # relaxed back to exact transport


@pytest.fixture
def one_rank_gloo(tmp_path):
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("bits", [8, 4, 16])
def test_compressed_mean_one_rank_matches_jax(jx, one_rank_gloo, bits):
    jax, jnp, JAC = jx
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    x = draw((256, 512), seed=6)
    mesh = jax.make_mesh((1,), ("pod",))
    f = shard_map(lambda v: JAC.compressed_mean(v, "pod", bits), mesh=mesh,
                  in_specs=P(), out_specs=P(), check_rep=False)
    want = np.asarray(f(jnp.asarray(x)))
    got = TAC.compressed_mean(torch.from_numpy(x), bits)
    np.testing.assert_array_equal(got.numpy(), want)
    if bits >= 16:
        np.testing.assert_array_equal(got.numpy(), x)


WORKER = textwrap.dedent("""
    import datetime, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.approx_comm import compressed_mean
    rank, store_path, x_path, out_path, bits = sys.argv[1:6]
    rank, bits = int(rank), int(bits)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, 2), rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=30))
    try:
        x = torch.from_numpy(np.load(x_path))
        np.save(out_path, compressed_mean(x, bits).numpy())
    finally:
        dist.destroy_process_group()
""")


@pytest.mark.parametrize("bits", [8])
def test_compressed_mean_two_ranks_is_the_mean_of_round_trips(tmp_path,
                                                              bits):
    xs = [draw((3, 1000), seed=10 + r, scale=1e-2) for r in range(2)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for r, x in enumerate(xs):
        np.save(tmp_path / f"x{r}.npy", x)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(tmp_path / "store"),
             str(tmp_path / f"x{r}.npy"), str(tmp_path / f"out{r}.npy"),
             str(bits)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a gloo worker did not finish within 60 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    want = sum(TAC._quant_roundtrip(torch.from_numpy(x), bits)
               for x in xs) / 2
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"out{r}.npy"),
                                      want.numpy())
