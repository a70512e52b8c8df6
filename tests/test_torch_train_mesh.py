"""``train(mesh_shape=...)`` over a 4-process gloo group against the
port's one-process run, on the CPU.

The four ranks are spawned once for the module (``torch.multiprocessing``,
a ``FileStore`` under the module's temporary directory) and run every case
in one process group, one after another: reduced ``qwen3-1.7b`` (batch 4,
seq 32, 3 steps) on ``(2, 2)`` and on ``(2, 1, 2)`` at ``grad_bits`` 16
and 8, reduced ``moonshot-v1-16b-a3b`` on ``(2, 2)`` (its experts over the
model axis, EP), step 0's DP-mean gradients of each 16-bit case
(``build_sharded_grads``), a recovery run on ``(2, 2)`` (a checkpoint at
step 2, a failure injected at step 3), and the refusal of a mesh whose
size is not the world size.  Each rank writes its losses, its resident
parameter and moment elements, its mean gradients and (rank 0) the final
whole parameters.

Every run takes AdamW at its full learning rate from the first step
(``warmup_steps=0``): under the default 100-step warmup three steps move
a parameter by at most ~2e-5, too little for a parameter check to see a
rank that skipped its update.

Held: per-step losses within 1e-5 relative of the one-process run with
the same seed; the mean gradients' global norm within 1e-5 relative and
every leaf within 1e-5 of the leaf's norm (AdamW and the clip ignore a
constant gradient scale, so only these see a DP sum left undivided);
what training changed in each leaf, ``p_mesh - p0`` against
``p_ref - p0``, within ``DELTA_RTOL`` (1e-3) of the one-process change's
norm (measured: at most 2.5e-5 at 16 bits, 1.1e-4 at 8); final
parameters within 1e-4 absolute (at 8 bits the quantize round trip of a
mean that differs from the one-process gradient in its last bits may
move q by one step: such elements, at most 1e-3 of them, are allowed, as
ROADMAP Queue 3's "Training at grad_bits=8" tolerates); every rank's
resident elements equal to its share by the specs (``param_specs`` on
the mesh: each leaf over its shard count, the two moments alike); the
recovery's losses equal to the one-process recovery's.  (``mesh_shape`` without a process
group raises: tests/test_torch_train.py::test_train_refuses_a_mesh.)
"""

import dataclasses
import datetime
import logging
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import TokenStream  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.steps import (build_sharded_grads,  # noqa: E402
                                      compute_grads)
from repro_torch.launch.train import MESH_AXES, step_batch, train  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, global_norm  # noqa: E402
from repro_torch.sharding import partition as TP  # noqa: E402
from repro_torch.sharding import spmd  # noqa: E402
from repro_torch.tree import tree_items, tree_leaves  # noqa: E402

WORLD = 4
RUN = dict(steps=3, batch=4, seq=32, seed=0, log_every=1000,
           opt=AdamWConfig(warmup_steps=0))
CASES = {
    "qwen3-2x2-16": dict(arch="qwen3-1.7b", mesh_shape=(2, 2),
                         grad_bits=16),
    "qwen3-2x2-8": dict(arch="qwen3-1.7b", mesh_shape=(2, 2), grad_bits=8),
    "qwen3-2x1x2-16": dict(arch="qwen3-1.7b", mesh_shape=(2, 1, 2),
                           grad_bits=16),
    "qwen3-2x1x2-8": dict(arch="qwen3-1.7b", mesh_shape=(2, 1, 2),
                          grad_bits=8),
    "moonshot-2x2-16": dict(arch="moonshot-v1-16b-a3b", mesh_shape=(2, 2),
                            grad_bits=16),
}
RECOVERY = dict(arch="qwen3-1.7b", mesh_shape=(2, 2), grad_bits=16,
                steps=5, checkpoint_every=2, inject_failure_at=3)
GRAD_CASES = sorted(k for k, c in CASES.items() if c["grad_bits"] >= 16)
TIMEOUT_S = 300
DELTA_RTOL = 1e-3


def _step0(arch: str) -> tuple:
    """(config, whole initial parameters, step 0's batch) on the CPU, as
    ``train`` draws them from ``RUN``'s seed."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              train_microbatches=1)
    g = torch.Generator(device="cpu")
    g.manual_seed(RUN["seed"])
    params = TR.build_model(cfg).init_params(g, device="cpu")
    raw = next(iter(TokenStream(cfg.vocab_size, RUN["batch"], RUN["seq"],
                                seed=RUN["seed"])))
    return cfg, params, step_batch(cfg, raw, 0, torch.device("cpu"))


def _mean_grads(case: dict) -> dict:
    """Step 0's loss and DP-mean gradients on ``case``'s mesh."""
    cfg, params, batch = _step0(case["arch"])
    shape = case["mesh_shape"]
    mesh = make_mesh(shape, MESH_AXES[len(shape)], device_type="cpu")
    shardings = TP.logical_to_sharding(
        TP.param_specs(TR.param_specs(cfg), cfg, mesh), mesh)
    loss, grads = build_sharded_grads(cfg, mesh)(
        spmd.shard_tree(params, shardings), batch)
    # the rank's blocks of the mean gradient, gathered whole to compare
    return {"loss": float(loss), "grads": spmd.full_tree(grads)}


def _rank_main(rank: int, root: str) -> None:
    """One rank: every case in one gloo group, results under ``root``."""
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    torch.set_num_threads(1)        # four ranks share the test worker's cores
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"), WORLD),
        rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=120))
    try:
        for name, case in CASES.items():
            kw = dict(RUN, **case)
            out = train(kw.pop("arch"), device="cpu", return_params=True,
                        **kw)
            torch.save({"losses": out["losses"], "resident": out["resident"],
                        "params": out["params"] if rank == 0 else None},
                       os.path.join(root, f"{name}-{rank}.pt"))
        for name in GRAD_CASES:
            torch.save(_mean_grads(CASES[name]),
                       os.path.join(root, f"grads-{name}-{rank}.pt"))
        kw = dict(RUN, **RECOVERY)
        out = train(kw.pop("arch"), device="cpu",
                    checkpoint_dir=os.path.join(root, "ckpt"), **kw)
        torch.save({"losses": out["losses"], "recoveries": out["recoveries"]},
                   os.path.join(root, f"recovery-{rank}.pt"))
        refused = []
        for shape in ((2, 1), (1, 2, 1, 2)):
            try:
                train("qwen3-1.7b", device="cpu", mesh_shape=shape, **RUN)
            except ValueError as e:
                refused.append(str(e))
        torch.save(refused, os.path.join(root, f"refused-{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the four ranks once; return a loader of their results."""
    root = str(tmp_path_factory.mktemp("train_mesh"))
    ctx = mp.start_processes(_rank_main, args=(root,), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=TIMEOUT_S)
    try:
        while not ctx.join(timeout=5):
            if datetime.datetime.now() > deadline:
                pytest.fail(f"the ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return lambda name, rank: torch.load(
        os.path.join(root, f"{name}-{rank}.pt"), weights_only=False)


def _one_process(case: dict, **extra) -> dict:
    """The one-process run, on one thread as each rank runs (the worker's
    other tests get their thread count back)."""
    kw = dict(RUN, **case)
    kw.pop("mesh_shape")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return train(kw.pop("arch"), device="cpu", **kw, **extra)
    finally:
        torch.set_num_threads(threads)


def _spec_share(arch: str, shape: tuple) -> int:
    cfg = get_config(arch).reduced()
    tree = TR.param_specs(cfg)
    mesh = TP.AbstractMesh(shape, MESH_AXES[len(shape)])
    share = spmd.spec_elements(tree, TP.param_specs(tree, cfg, mesh), mesh)
    assert share < sum(math.prod(x.shape) for _, x in tree_items(tree))
    return share


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_training_matches_one_process(ranks, name):
    case = CASES[name]
    ref = _one_process(case, return_params=True)
    share = _spec_share(case["arch"], case["mesh_shape"])
    for rank in range(WORLD):
        got = ranks(name, rank)
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5,
                                   atol=0)
        assert got["resident"] == {"params": share, "moments": 2 * share}
    params = ranks(name, 0)["params"]
    p0 = _step0(case["arch"])[1]
    moved, total = 0, 0
    for (key, a), (rkey, b), (_, c) in zip(
            tree_items(params), tree_items(ref["params"]), tree_items(p0),
            strict=True):
        assert key == rkey and a.shape == b.shape
        # what training changed: (a - c) against (b - c)
        change = float((b - c).norm())
        assert change > 0, key
        assert float((a - b).norm()) <= DELTA_RTOL * change, key
        far = (a - b).abs() > 1e-4
        if case["grad_bits"] >= 16:
            assert not far.any(), key
        moved += int(far.sum())
        total += a.numel()
    assert moved <= 1e-3 * total, (moved, total)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_mesh_gradients_match_one_process(ranks, name):
    """Step 0's DP-mean gradients on every rank against the one-process
    ``compute_grads`` over the whole batch."""
    cfg, params, batch = _step0(CASES[name]["arch"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss, want = compute_grads(TR.build_model(cfg), params, batch, 1)
    finally:
        torch.set_num_threads(threads)
    norm = float(global_norm(tree_leaves(want)))
    for rank in range(WORLD):
        got = ranks(f"grads-{name}", rank)
        assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        assert abs(float(global_norm(tree_leaves(got["grads"]))) - norm) \
            <= 1e-5 * norm, rank
        for (key, g), (_, w) in zip(tree_items(got["grads"]),
                                    tree_items(want), strict=True):
            assert float((g - w).norm()) <= 1e-5 * float(w.norm()), \
                (rank, key)


def test_mesh_training_recovers_from_a_checkpoint(ranks, tmp_path):
    ref = _one_process(RECOVERY, checkpoint_dir=str(tmp_path / "ckpt"))
    assert ref["recoveries"] == [(3, 2)]
    for rank in range(WORLD):
        got = ranks("recovery", rank)
        assert got["recoveries"] == ref["recoveries"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5,
                                   atol=0)


def test_mesh_of_another_size_raises(ranks):
    for rank in range(WORLD):
        refused = ranks("refused", rank)
        assert len(refused) == 2
        assert "2 ranks, the process group 4" in refused[0]
        assert "(data, model) or (pod, data, model)" in refused[1]
