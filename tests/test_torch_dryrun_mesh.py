"""The dry-run's ``--mesh``: one device's share of a cell's step, on the
CPU.

  * Per-device argument bytes (``dryrun.argument_bytes``, the local shapes
    of the step's arguments on the production meshes ``(16, 16)`` and
    ``(2, 16, 16)``) equal, for every arch and cell, the sum over the
    leaves of JAX's own shapes of their local shapes under JAX's
    ``param_specs`` / ``opt_state_specs`` / ``batch_specs`` /
    ``cache_specs`` (a cache's ``length``, a device scalar there, is a
    host int in the port and holds no bytes).  No meta pass.
  * The collectives a rank's step issues, counted by ``MetaPass`` over a
    fake ``(2, 4)`` process group (``launch.mesh.fake_mesh``) for reduced
    cells, equal formulas written here from the configs (layers, the
    leaves the DP axes split, which heads divide the model axis) -- not
    from the code's record.
  * At model axis 1 a step issues no model-axis collective, and a rank's
    temporaries at model axis 4 are below those at 1 (qwen3, rwkv6,
    enc-dec and zamba2).
  * The ``sequence_parallel`` hint on a 2-layer cut of ``llama3-8b``
    ``train_4k`` on the fake ``(16, 16)`` group: lower temporaries, and
    the all-reduces it turns into reduce-scatters and all-gathers,
    counted from the code's sites.
  * Every family's record is marked ``"compute"``, and its rank's step on
    the fake ``(2, 4)`` group takes the argument bytes of JAX's specs.

Every fake group lives behind ``fake_mesh``'s teardown, so none is left in
the pytest worker.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, SHAPE_CELLS, cells_for  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import fake_mesh  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.sharding import partition as TP  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
AXES = ("data", "model")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    from jax.sharding import AbstractMesh
    from repro.configs import get_config as jget
    from repro.configs.base import SHAPE_CELLS as JCELLS
    from repro.models import registry as JR
    from repro.sharding import api as JA
    from repro.sharding import partition as JP
    JA.deactivate()
    return dict(jax=jax, AbstractMesh=AbstractMesh, get_config=jget,
                CELLS=JCELLS, R=JR, P=JP)


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return TR.param_specs(get_config(arch))


@pytest.fixture(autouse=True)
def _cached_params(monkeypatch):
    """The bundles draw each published arch's meta parameter tree once."""
    monkeypatch.setattr(TS, "param_specs", lambda cfg: (
        _port_params(cfg.name) if get_config(cfg.name) == cfg
        else TR.param_specs(cfg)) if cfg.name in ARCHS
        else TR.param_specs(cfg))


def _jax_local_bytes(jx, structs, specs, mesh, skip_scalars=False) -> int:
    """The sum over leaves of a JAX tree of structs of their local bytes
    under a tree of JAX specs on ``mesh``."""
    jax = jx["jax"]
    leaves = jax.tree_util.tree_leaves(structs)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for x, spec in zip(leaves, spec_leaves):
        if skip_scalars and x.ndim == 0:
            continue
        shape = list(x.shape)
        for d, entry in enumerate(spec):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            shape[d] //= math.prod(mesh.shape[a] for a in axes)
        total += math.prod(shape) * np.dtype(x.dtype).itemsize
    return total


def _jax_argument_bytes(jx, arch, shape, mesh) -> int:
    jax, R, P = jx["jax"], jx["R"], jx["P"]
    cfg = jx["get_config"](arch)
    cell = jx["CELLS"][shape]
    model = R.build_model(cfg)
    params = jax.eval_shape(lambda: model.init_params(
        jax.random.PRNGKey(0)))
    total = _jax_local_bytes(jx, params, P.param_specs(params, cfg, mesh),
                             mesh)
    specs = R.input_specs(cfg, cell)
    if cell.kind == "train":
        from repro.optim.adamw import init_opt_state
        opt = jax.eval_shape(init_opt_state, params)
        total += _jax_local_bytes(jx, opt, P.opt_state_specs(params, cfg,
                                                             mesh), mesh)
    if cell.kind in ("train", "prefill"):
        batch = specs["batch"]
        total += _jax_local_bytes(jx, batch, P.batch_specs(batch, cfg, mesh,
                                                           cell), mesh)
    if cell.kind == "prefill":
        cache = R.cache_spec(cfg, cell.global_batch, cell.seq_len)
    elif cell.kind == "decode":
        cache = specs["cache"]
        tokens = {"tokens": specs["tokens"]}
        total += _jax_local_bytes(jx, tokens, P.batch_specs(
            tokens, cfg, mesh, cell), mesh)
    if cell.kind != "train":
        total += _jax_local_bytes(jx, cache, P.cache_specs(cache, cfg, mesh,
                                                           cell), mesh,
                                  skip_scalars=True)
    return total


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_argument_bytes_match_jax_specs(jx, arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    jmesh = jx["AbstractMesh"](shape, axes)
    tmesh = TP.AbstractMesh(shape, axes)
    for cell in cells_for(arch):
        got = D.argument_bytes(get_config(arch), SHAPE_CELLS[cell], tmesh)
        assert got == _jax_argument_bytes(jx, arch, cell, jmesh), cell


# -- collectives on a fake (2, 4) mesh -----------------------------------------

DP, M = 2, 4
CELLS = {"prefill": ShapeCell("prefill", 32, 4, "prefill"),
         "decode": ShapeCell("decode", 32, 4, "decode"),
         "train": ShapeCell("train", 32, 4, "train")}


def _account(cfg, cell, shape=(DP, M)):
    with fake_mesh(shape, AXES) as mesh:
        return D.account_mesh(cfg, cell, mesh)


def _counts(rec) -> dict:
    return {k: v["count"] for k, v in rec["collectives"].items()}


def _fsdp_leaves(cfg) -> int:
    """A layer's leaves the specs split over the DP axes (the ``d_model``
    dims divide the DP size at the reduced width): the four attention
    projections and the dense FFN's two or three, or the MoE's router,
    three expert stacks and the shared experts' three."""
    if cfg.family == "moe":
        return 4 + 1 + 3 + (3 if cfg.num_shared_experts else 0)
    return 4 + (3 if cfg.act == "swiglu" else 2)


def _kv_gathers(cfg, m: int) -> int:
    """K and V gathered over the model axis before prefill attention:
    none where the KV heads divide it, two where the query heads do, and
    Q too where they do not."""
    qh, kh = cfg.num_heads, cfg.num_kv_heads
    if qh % m:
        return 3
    return 0 if kh % m == 0 else 2


def _formula(cfg, kind: str, m: int = M) -> dict:
    """Counts by kind of one rank's step of a reduced attention-family
    config on ``(DP, m)``, its cache's rows split over the model axis."""
    n = cfg.num_layers
    fsdp = _fsdp_leaves(cfg)
    head = 2      # the embedding's FSDP block, then the head's (tied or not)
    out = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
           "all-to-all": 0, "collective-permute": 0}
    if kind == "prefill":
        g = _kv_gathers(cfg, m)
        out["all-gather"] = head + n * (fsdp + g)
        out["all-reduce"] = 1 + 2 * n          # the lookup, wo, the FFN
        out["all-to-all"] = 2 * n if g == 0 else 0   # cache rows, K and V
    elif kind == "decode":
        # Q, K, V of every head, and the log-sum-exps
        out["all-gather"] = head + n * (fsdp + 3 + 1)
        out["all-reduce"] = 1 + 2 * n
        out["reduce-scatter"] = n              # the merge, the rank's heads
    return out


def _train_formula(cfg, microbatches: int) -> dict:
    """One training step under ``remat="full"``: each microbatch's forward
    issues a layer's collectives twice (the backward's recomputation),
    but for the FFN's all-reduce: the recomputation stops after the last
    tensor the backward saves, and nothing saves that sum.  Its backward
    reduce-scatters every FSDP gather and all-reduces every Megatron
    ``f`` (the attention's and the FFN's input, qwen3's two qk-norm
    scales, the head's input).  Then the leaves the DP axes leave whole
    are summed over the DP group, the loss is averaged and the norm
    taken."""
    n, fsdp, g = cfg.num_layers, _fsdp_leaves(cfg), _kv_gathers(cfg, M)
    f = 2 + (2 if cfg.qk_norm else 0)
    gathers = 1 + 2 * n * (fsdp + g) + 1
    scatters = n * (fsdp + g) + 2
    reduces = (1 + n * (2 + 1) + 3        # lookup, wo twice + FFN, the loss
               + n * f + 1)                # the f's, the head's input
    replicated = 3 + (2 if cfg.qk_norm else 0)  # the norms (+ qk scales)
    return {"all-gather": microbatches * gathers,
            "reduce-scatter": microbatches * scatters,
            "all-reduce": microbatches * reduces + replicated + 2,
            "all-to-all": 0, "collective-permute": 0}


FORMULA_ARCHS = ["qwen3-1.7b", "llama3-8b", "moonshot-v1-16b-a3b",
                 "qwen2-vl-72b"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FORMULA_ARCHS)
def test_serving_collectives_follow_the_formula(arch, kind):
    cfg = get_config(arch).reduced()
    rec = _account(cfg, CELLS[kind])
    assert rec["model_axis"] == "compute"
    assert _counts(rec) == _formula(cfg, kind)


def test_heads_that_do_not_divide_gather_q_too():
    cfg = dataclasses.replace(get_config("phi3-medium-14b").reduced(),
                              num_heads=6, num_kv_heads=3)
    assert _counts(_account(cfg, CELLS["prefill"])) == _formula(cfg,
                                                                "prefill")
    cfg = dataclasses.replace(cfg, num_heads=8, num_kv_heads=4)
    rec = _account(cfg, CELLS["prefill"])
    assert rec["collectives"]["all-to-all"]["count"] == 2 * cfg.num_layers
    assert _counts(rec) == _formula(cfg, "prefill")


def test_train_collectives_follow_the_formula():
    cfg = get_config("qwen3-1.7b").reduced()
    assert cfg.remat == "full"
    mb = TS.microbatch_count(cfg, CELLS["train"].global_batch, DP)
    assert mb == 2
    assert _counts(_account(cfg, CELLS["train"])) == _train_formula(cfg, mb)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_model_axis_one_issues_no_model_collective(kind):
    """At ``(4, 1)`` only the FSDP gathers remain: every all-reduce,
    reduce-scatter and all-to-all of a serving step is the model axis's."""
    cfg = get_config("qwen3-1.7b").reduced()
    got = _counts(_account(cfg, CELLS[kind], (4, 1)))
    assert got == {"all-gather": 2 + cfg.num_layers * _fsdp_leaves(cfg),
                   "all-reduce": 0, "reduce-scatter": 0, "all-to-all": 0,
                   "collective-permute": 0}


def test_sequence_parallel_trades_all_reduces_for_reduce_scatters():
    """The ``sequence_parallel`` hint on a 2-layer cut of ``llama3-8b``
    ``train_4k`` on the fake ``(16, 16)`` group (its 32 query heads divide
    16, so ``wo`` is row-parallel; the 8 KV heads do not, and are gathered
    as without the hint): a rank's temporaries fall, and the collectives
    move by the counts of the code's sites.

    Per microbatch (8 of them, each 2 of the 256 rows a rank) and layer,
    under ``remat="full"`` (the forward's collectives issued again in the
    backward's recomputation, but for the FFN's last one, which nothing
    saved reads):

      * the ``wo`` all-reduce (twice) and the FFN's (once) become
        reduce-scatters; the attention's and the FFN's ``copy_to`` (an
        all-reduce each in the backward pass) become ``gather_summed``:
        an all-gather forward (twice) and a reduce-scatter backward; each
        ``scatter_from``'s backward is an all-gather;
      * the two norms' scales, used on the rank's rows, have their
        gradients all-reduced (``seq_weight``);

    and once a microbatch: the embedding's all-reduce becomes a
    reduce-scatter (an all-gather backward), the head's ``copy_to`` a
    ``gather_summed`` (an all-gather forward, a reduce-scatter backward),
    and the final norm's scale adds an all-reduce."""
    cfg = D.depth_cut(get_config("llama3-8b"), 2)
    n, mb = cfg.num_layers, 8
    cell = SHAPE_CELLS["train_4k"]
    assert TS.microbatch_count(cfg, cell.global_batch, 16) == mb
    recs = {}
    for hint in (False, True):
        with fake_mesh(*MESHES["single"]) as mesh:
            recs[hint] = D.account_mesh(dataclasses.replace(
                cfg, sequence_parallel=hint), cell, mesh)
    off, on = (_counts(recs[h]) for h in (False, True))
    assert recs[True]["memory"]["temp_bytes"] < \
        recs[False]["memory"]["temp_bytes"]
    row_parallel = 2 * n + n      # wo's sums twice, the FFN's once
    entries = 2 * n               # the attention's and the FFN's input
    # all-reduces: the sums, the entries' backward, the norms' scales
    # (+2n), the embedding (-1), the head's input (-1), the final norm
    ar = -row_parallel - entries + 2 * n - 1 - 1 + 1
    # reduce-scatters: the sums, the entries' backward, embedding, head
    rs = row_parallel + entries + 1 + 1
    # all-gathers: the entries forward and recomputed, the sums' backward,
    # the embedding's backward, the head's input
    ag = 2 * entries + 2 * n + 1 + 1
    assert {k: on[k] - off[k] for k in off} == {
        "all-reduce": mb * ar, "reduce-scatter": mb * rs,
        "all-gather": mb * ag, "all-to-all": 0, "collective-permute": 0}


# (arch, kind): qwen3's cases keep their ids from before the other
# families partitioned their compute
TEMP_CASES = [pytest.param("qwen3-1.7b", k, id=k) for k in ("prefill",
                                                            "train")] + [
    pytest.param(a, k, id=f"{a}-{k}")
    for a in ("rwkv6-1.6b", "seamless-m4t-large-v2", "zamba2-7b")
    for k in ("prefill", "train")]


@pytest.mark.parametrize("arch,kind", TEMP_CASES)
def test_temporaries_fall_with_the_model_axis(arch, kind):
    cfg = get_config(arch).reduced()
    cell = dataclasses.replace(CELLS[kind], seq_len=128)
    at = {m: _account(cfg, cell, (DP, m))["memory"]["temp_bytes"]
          for m in (1, M)}
    assert at[M] < at[1], at


def _jax_reduced_argument_bytes(jx, arch: str, cell, mesh) -> int:
    """JAX's local argument bytes of a reduced arch's ``cell`` (the port's
    ``ShapeCell``, carried over) on the JAX mesh ``mesh``."""
    from repro.configs.base import ShapeCell as JCell
    jax, R, P = jx["jax"], jx["R"], jx["P"]
    cfg = jx["get_config"](arch).reduced()
    jcell = JCell(cell.name, cell.seq_len, cell.global_batch, cell.kind)
    params = jax.eval_shape(lambda: R.build_model(cfg).init_params(
        jax.random.PRNGKey(0)))
    total = _jax_local_bytes(jx, params, P.param_specs(params, cfg, mesh),
                             mesh)
    specs = R.input_specs(cfg, jcell)
    if cell.kind == "train":
        from repro.optim.adamw import init_opt_state
        opt = jax.eval_shape(init_opt_state, params)
        total += _jax_local_bytes(jx, opt, P.opt_state_specs(params, cfg,
                                                             mesh), mesh)
    if cell.kind in ("train", "prefill"):
        batch = specs["batch"]
        total += _jax_local_bytes(jx, batch, P.batch_specs(batch, cfg, mesh,
                                                           jcell), mesh)
    if cell.kind == "prefill":
        cache = R.cache_spec(cfg, cell.global_batch, cell.seq_len)
    elif cell.kind == "decode":
        cache = specs["cache"]
        tokens = {"tokens": specs["tokens"]}
        total += _jax_local_bytes(jx, tokens, P.batch_specs(
            tokens, cfg, mesh, jcell), mesh)
    if cell.kind != "train":
        total += _jax_local_bytes(jx, cache, P.cache_specs(cache, cfg, mesh,
                                                           jcell), mesh,
                                  skip_scalars=True)
    return total


@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-1.6b",
                                  "seamless-m4t-large-v2", "zamba2-7b"])
def test_each_family_computes_on_its_blocks(jx, arch, kind):
    """Every family's record is marked ``"compute"`` (the model axis
    partitions its products), and the rank's step takes the argument
    bytes of JAX's specs on the fake ``(2, 4)`` mesh."""
    cfg = get_config(arch).reduced()
    rec = _account(cfg, CELLS[kind])
    assert rec["model_axis"] == "compute"
    want = _jax_reduced_argument_bytes(jx, arch, CELLS[kind],
                                       jx["AbstractMesh"]((DP, M), AXES))
    assert rec["memory"]["argument_bytes"] == want
