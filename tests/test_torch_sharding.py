"""The port's sharding rules (``repro_torch.sharding``) against the JAX
package's, spec for spec, at the production meshes.

Both packages compute the specs on meshes with no devices: JAX on
``jax.sharding.AbstractMesh``, the port on its own ``AbstractMesh``, at
``(16, 16)`` ``("data", "model")`` and ``(2, 16, 16)`` ``("pod", "data",
"model")``.  The trees are the published widths': JAX's from
``jax.eval_shape`` and ``input_specs`` / ``cache_spec``, the port's from
its meta ``registry.param_specs`` / ``input_specs``.  Held exactly, leaf
for leaf in JAX's leaf order: ``param_specs``, ``opt_state_specs``, and
for every cell of ``cells_for(arch)`` ``batch_specs`` or ``cache_specs``
and the step bundles' ``in_shardings`` / ``out_shardings`` (JAX's
``build_train_step`` / ``build_prefill_step`` / ``build_serve_step`` on
the abstract mesh, the port's ``build_train_bundle`` /
``build_prefill_step`` / ``build_serve_step`` with ``mesh=``), for all
ten archs, then again under ``zero3``, ``sequence_parallel`` (phi3's 40
heads against 16), ``moe_parallel="tp"`` (both MoE archs) and
``fsdp=False``.  The JAX builders turn their sharding context on; a
fixture turns it off around every test.  ``active_axes`` against JAX's;
the placements and local blocks of ``NamedSharding``; ``make_mesh``'s
refusals.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import mesh as TMesh  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.sharding import api as TA  # noqa: E402
from repro_torch.sharding import partition as TP  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
# (label, arch, config changes): where each hint bites
VARIANTS = [("zero3", "qwen3-1.7b", {"zero3": True}),
            ("zero3-moe", "moonshot-v1-16b-a3b", {"zero3": True}),
            ("sequence_parallel", "phi3-medium-14b",
             {"sequence_parallel": True}),
            ("moe_tp", "moonshot-v1-16b-a3b", {"moe_parallel": "tp"}),
            ("moe_tp", "phi3.5-moe-42b-a6.6b", {"moe_parallel": "tp"}),
            ("no_fsdp", "llama3-8b", {"fsdp": False})]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import types

    import jax
    from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec
    from repro import configs as JC
    from repro.configs import base as JB
    from repro.launch import steps as JS
    from repro.models import registry as JR
    from repro.sharding import api as JA
    from repro.sharding import partition as JP
    JA.deactivate()
    yield types.SimpleNamespace(jax=jax, AbstractMesh=AbstractMesh,
                                NamedSharding=NamedSharding,
                                PartitionSpec=PartitionSpec, C=JC, B=JB,
                                S=JS, R=JR, A=JA, P=JP)
    JA.deactivate()


@pytest.fixture(autouse=True)
def _no_jax_mesh(request, monkeypatch):
    """JAX's step builders activate a sharding mesh; switch it off.  The
    port's builders draw the meta parameter tree once an arch (the hints
    change no shape)."""
    monkeypatch.setattr(TS, "param_specs",
                        lambda cfg: _port_params(cfg.name))
    yield
    if "jx" in request.fixturenames:
        request.getfixturevalue("jx").A.deactivate()


def _jax_specs(jx, tree):
    """JAX spec leaves (of specs or NamedShardings) as plain tuples."""
    leaves = jx.jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, (jx.PartitionSpec,
                                               jx.NamedSharding)))
    return [tuple(x.spec if isinstance(x, jx.NamedSharding) else x)
            for x in leaves]


def _port_specs(tree):
    return [tuple(x) for x in TP.spec_leaves(tree)]


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return TR.param_specs(TC.get_config(arch))


_JAX_PARAMS: dict = {}


def _jax_params(jx, arch):
    if arch not in _JAX_PARAMS:
        cfg = jx.C.get_config(arch)
        model = jx.R.build_model(cfg)
        _JAX_PARAMS[arch] = jx.jax.eval_shape(
            lambda: model.init_params(jx.jax.random.PRNGKey(0)))
    return _JAX_PARAMS[arch]


def _configs(jx, arch, changes):
    return (dataclasses.replace(jx.C.get_config(arch), **changes),
            dataclasses.replace(TC.get_config(arch), **changes))


def _meshes(jx, name):
    shape, axes = MESHES[name]
    return jx.AbstractMesh(shape, axes), TP.AbstractMesh(shape, axes)


def _check_params(jx, arch, changes, mesh_name):
    jcfg, tcfg = _configs(jx, arch, changes)
    jmesh, tmesh = _meshes(jx, mesh_name)
    jtree, ttree = _jax_params(jx, arch), _port_params(arch)
    want = _jax_specs(jx, jx.P.param_specs(jtree, jcfg, jmesh))
    got = _port_specs(TP.param_specs(ttree, tcfg, tmesh))
    assert got == want
    assert _port_specs(TP.opt_state_specs(ttree, tcfg, tmesh)) == \
        _jax_specs(jx, jx.P.opt_state_specs(jtree, jcfg, jmesh))
    return want


def _check_cells(jx, arch, changes, mesh_name):
    """batch / cache specs and both bundles' shardings of every cell."""
    jcfg, tcfg = _configs(jx, arch, changes)
    jmesh, tmesh = _meshes(jx, mesh_name)
    builders = {"train": (jx.S.build_train_step, TS.build_train_bundle),
                "prefill": (jx.S.build_prefill_step, TS.build_prefill_step),
                "decode": (jx.S.build_serve_step, TS.build_serve_step)}
    for name in TC.cells_for(arch):
        jcell, tcell = jx.B.SHAPE_CELLS[name], TC.SHAPE_CELLS[name]
        jin, tin = jx.R.input_specs(jcfg, jcell), TR.input_specs(tcfg, tcell)
        if tcell.kind == "decode":
            want = jx.P.cache_specs(jin["cache"], jcfg, jmesh, jcell)
            got = TP.cache_specs(tin["cache"], tcfg, tmesh, tcell)
        else:
            want = jx.P.batch_specs(jin["batch"], jcfg, jmesh, jcell)
            got = TP.batch_specs(tin["batch"], tcfg, tmesh, tcell)
        assert _port_specs(got) == _jax_specs(jx, want), name
        build_j, build_t = builders[tcell.kind]
        try:
            jb = build_j(jcfg, jcell, jmesh)
        finally:
            jx.A.deactivate()
        tb = build_t(tcfg, tcell, mesh=tmesh, device="meta")
        for side in ("in_shardings", "out_shardings"):
            assert _port_specs(getattr(tb, side)) == \
                _jax_specs(jx, getattr(jb, side)), (name, side)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_param_and_opt_state_specs_match_jax(jx, arch, mesh_name):
    want = _check_params(jx, arch, {}, mesh_name)
    # the published widths shard something on every arch
    assert any(any(e is not None for e in s) for s in want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_cell_and_bundle_specs_match_jax(jx, arch, mesh_name):
    _check_cells(jx, arch, {}, mesh_name)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("label,arch,changes", VARIANTS,
                         ids=[f"{v[0]}-{v[1]}" for v in VARIANTS])
def test_hinted_specs_match_jax(jx, label, arch, changes, mesh_name):
    """Each hint on an arch where it changes the specs: the hinted specs
    equal JAX's and differ from the unhinted ones."""
    hinted = _check_params(jx, arch, changes, mesh_name)
    plain = _check_params(jx, arch, {}, mesh_name)
    assert hinted != plain, label
    _check_cells(jx, arch, changes, mesh_name)


def test_sequence_parallel_drops_model_only_where_heads_do_not_divide(jx):
    """phi3's 40 heads: attention weights lose the model axis; llama3's 32
    keep it (JAX's escape rule)."""
    mesh = TP.AbstractMesh(*MESHES["single"])
    for arch, dropped in (("phi3-medium-14b", True), ("llama3-8b", False)):
        cfg = dataclasses.replace(TC.get_config(arch), sequence_parallel=True)
        specs = TP.param_specs(_port_params(arch), cfg, mesh)["layers"]
        assert (specs["wq"] == TP.PartitionSpec(None, "data", None)) \
            == dropped
        assert specs["w_gate"] == TP.PartitionSpec(None, "data", "model")


@pytest.mark.parametrize("zero3", [False, True])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_active_axes_match_jax(jx, mesh_name, zero3):
    jmesh, tmesh = _meshes(jx, mesh_name)
    try:
        jx.A.activate(jmesh, zero3=zero3)
        want = jx.A.active_axes()
    finally:
        jx.A.deactivate()
    TA.activate(tmesh, zero3=zero3)
    try:
        got = TA.active_axes()
        x = torch.zeros(2, 3)
        assert TA.shard(x, "dp", "model") is x
        with pytest.raises(AssertionError):
            TA.shard(x, "dp")
    finally:
        TA.deactivate()
    assert got == want
    assert TA.active_axes() is None


def test_partition_spec_normalizes_like_jax(jx):
    for entries in [(("data",), None), (("pod", "data"), "model"), ((),),
                    ("model", ("data",))]:
        assert tuple(TP.PartitionSpec(*entries)) == \
            tuple(jx.PartitionSpec(*entries))


def test_named_sharding_placements_and_blocks():
    """Two mesh axes on one dim split it major-to-minor in the mesh's
    order (JAX's P(("pod", "data"))): every coordinate's block, stacked in
    coordinate order, gives the tensor back."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = TP.AbstractMesh((2, 3, 2), ("pod", "data", "model"))
    x = torch.arange(12 * 4 * 5, dtype=torch.float32).reshape(12, 4, 5)
    sh = TP.NamedSharding(mesh, TP.PartitionSpec(("pod", "data"), "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(1))
    assert sh.local_shape(x.shape) == (2, 2, 5)
    rows = []
    for p in range(2):
        for d in range(3):
            blk = [sh.local_block(x, (p, d, m)) for m in range(2)]
            rows.append(torch.cat(blk, dim=1))
    assert torch.equal(torch.cat(rows, dim=0), x)
    assert TP.NamedSharding(mesh, TP.PartitionSpec()).placements == \
        (Replicate(),) * 3
    for bad in [TP.PartitionSpec(("data", "pod")),
                TP.PartitionSpec("data", "data"), TP.PartitionSpec("x")]:
        with pytest.raises(ValueError):
            TP.NamedSharding(mesh, bad)
    with pytest.raises(ValueError, match="does not split"):
        sh.local_shape((10, 4, 5))


def test_train_bundle_microbatches_follow_the_mesh():
    """build_train_step's microbatch count at the mesh's DP size (JAX
    steps.py:62-72): qwen3's 4 microbatches of train_4k's 256 rows keep
    64 rows, a multiple of 32 (pod x data), but not of 512 (zero3)."""
    cfg = TC.get_config("qwen3-1.7b")
    multi = TMesh.production_mesh_shape(multi_pod=True)
    assert TP.dp_size(multi, cfg) == 32
    assert TS.microbatch_count(cfg, 256, TP.dp_size(multi, cfg)) == 4
    z3 = dataclasses.replace(cfg, zero3=True)
    assert TP.dp_size(multi, z3) == 512
    assert TS.microbatch_count(z3, 256, TP.dp_size(multi, z3)) == 1
    bundle = TS.build_train_bundle(cfg, TC.SHAPE_CELLS["train_4k"],
                                   device="meta")
    assert bundle.in_shardings is None and bundle.out_shardings is None


def test_make_mesh_needs_a_process_group_of_its_size(tmp_path):
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        TMesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        TMesh.make_production_mesh(device_type="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="256 ranks"):
            TMesh.make_production_mesh(device_type="cpu")
        mesh = TMesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
        assert TP.mesh_axes(mesh) == TP.AbstractMesh((1, 1),
                                                     ("data", "model"))
        sh = TP.NamedSharding(mesh, TP.PartitionSpec("model", "data"))
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=(4, 6)).astype(np.float32))
        d = sh.distribute(x)
        assert torch.equal(d.full_tensor(), x)
        assert tuple(d.to_local().shape) == (4, 6)
    finally:
        dist.destroy_process_group()
    assert TMesh.production_mesh_shape().shape == {"data": 16, "model": 16}
