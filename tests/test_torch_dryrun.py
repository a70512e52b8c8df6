"""The port's dry-run pieces against the JAX package's.

Held exactly: ``SHAPE_CELLS``; ``cells_for`` and the keys of
``skipped_cells_for`` for every arch; ``param_count``,
``active_param_count``, ``is_attention_free`` and
``supports_long_context`` for every arch, published and ``reduced()``;
every leaf's shape and dtype of ``input_specs`` (and so ``cache_spec``)
for every arch x runnable cell against the JAX function under
``jax.eval_shape``; the bytes of the meta parameter tree against those of
``jax.eval_shape(model.init_params)`` for every published config.

Held within the tolerance each family's own parity test states: the
``build_prefill_step`` / ``build_serve_step`` bundles' ``fn`` against the
JAX bundles' on the same parameters (NumPy draws in the JAX
``init_params`` tree's shapes, carried over by
``convert.model_params_from_numpy``), the same NumPy-seeded batch, and
for a serve step the same NumPy-seeded cache at ``length = seq_len``, at
``reduced()`` widths, one prefill and one serve cell a family: logits and
every cache leaf.  Dense (``test_torch_transformer.py``) and SSM
(``test_torch_rwkv6.py``): 1e-4 absolute; MoE, VLM, hybrid and audio
(``test_torch_moe.py``, ``test_torch_vlm.py``, ``test_torch_zamba2.py``,
``test_torch_encdec.py``): 1e-5 of the largest |value|.  The JAX bundles
are built under a one-device ``("data", "model")`` mesh whose axes are
``Auto``: ``repro.launch.mesh.make_mesh`` gives ``Explicit`` axes on this
JAX, under which the JAX model's ``shard(...)`` constraints raise (the
failure ROADMAP Queue 3 records for ``launch/train.py``); the builders
activate the JAX sharding context and a fixture deactivates it after.

The dry-run's accounting (``launch/dryrun.py``): ``run_cell`` on the meta
device at the published widths for two cheap cells (the bytes of the
issue's table: qwen3's 484.8 GB ``decode_32k`` cache, rwkv6's 0.01 GB
``long_500k`` state), at ``reduced()`` widths for every cell, ``find_cut``
against a brute-force search, the meta loops that stand a
representative in for repeated iterations against the same pass running
every iteration, and ``card_compare`` (the card phase's comparison of a
kernel step with the plain step) on the CPU for every family.  No test
imports ``repro.launch.dryrun`` (it sets ``XLA_FLAGS`` at import) or
calls ``make_production_mesh``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch import meta as TM  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPE_CELLS, ShapeCell,  # noqa: E402
                                 cells_for, get_config, skipped_cells_for)
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import H100  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402

FAMILY_ARCH = {"dense": "qwen3-1.7b", "moe": "moonshot-v1-16b-a3b",
               "vlm": "qwen2-vl-72b", "ssm": "rwkv6-1.6b",
               "hybrid": "zamba2-7b", "audio": "seamless-m4t-large-v2"}
# (kind, value): "abs" bounds max |got - want|, "share" bounds it over
# max |want|
TOL = {"dense": ("abs", 1e-4), "ssm": ("abs", 1e-4),
       "moe": ("share", 1e-5), "vlm": ("share", 1e-5),
       "hybrid": ("share", 1e-5), "audio": ("share", 1e-5)}
B, S_PREFILL, S_SERVE = 2, 32, 40


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces; the sharding context its step builders
    turn on is switched off before and after."""
    pytest.importorskip("jax")
    import types

    import jax
    import jax.numpy as jnp
    from repro import configs as JC
    from repro.configs import base as JB
    from repro.launch import steps as JS
    from repro.models import registry as JR
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    yield types.SimpleNamespace(jax=jax, jnp=jnp, C=JC, B=JB, S=JS, R=JR,
                                shard_api=shard_api)
    shard_api.deactivate()


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _leaves(obj, prefix=""):
    """(path, leaf) of a dict / dataclass tree, ``length`` fields left out
    (a host int in the port, an int32 scalar in JAX)."""
    if isinstance(obj, dict):
        return [x for k in sorted(obj)
                for x in _leaves(obj[k], f"{prefix}{k}/")]
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj) if f.name != "length"
                for x in _leaves(getattr(obj, f.name), f"{prefix}{f.name}/")]
    return [(prefix.rstrip("/"), obj)]


def _signature(tree):
    return [(k, tuple(v.shape), _dtype_name(v.dtype)) for k, v in
            _leaves(tree)]


# -- configs ------------------------------------------------------------------


def test_shape_cells_match_jax(jx):
    assert list(SHAPE_CELLS) == list(jx.B.SHAPE_CELLS)
    for name, cell in SHAPE_CELLS.items():
        want = jx.B.SHAPE_CELLS[name]
        assert dataclasses.asdict(cell) == dataclasses.asdict(want)
        assert cell.tokens == want.tokens


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cells_match_jax(jx, arch):
    assert cells_for(arch) == jx.C.cells_for(arch)
    assert sorted(skipped_cells_for(arch)) == sorted(
        jx.C.skipped_cells_for(arch))


def test_cell_counts():
    assert sum(len(cells_for(a)) for a in ARCHS) == 32
    assert sum(len(skipped_cells_for(a)) for a in ARCHS) == 8


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_methods_match_jax(jx, arch, reduced):
    t, j = get_config(arch), jx.C.get_config(arch)
    if reduced:
        t, j = t.reduced(), j.reduced()
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert t.is_attention_free == j.is_attention_free
    assert t.supports_long_context == j.supports_long_context


# -- meta stand-ins -----------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_jax(jx, arch):
    """Every runnable cell's stand-ins: shapes and dtypes of every leaf
    (a decode cell's cache is ``cache_spec``'s), all on the meta
    device."""
    for shape in cells_for(arch):
        cell = SHAPE_CELLS[shape]
        got = TR.input_specs(get_config(arch), cell)
        want = jx.R.input_specs(jx.C.get_config(arch), jx.B.SHAPE_CELLS[shape])
        assert sorted(got) == sorted(want), shape
        assert _signature(got) == _signature(want), shape
        assert all(t.device.type == "meta" for _, t in _leaves(got))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_bytes_match_jax(jx, arch):
    jax = jx.jax
    model = jx.R.build_model(jx.C.get_config(arch))
    tree = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    want = sum(x.size * x.dtype.itemsize for x in
               jax.tree_util.tree_leaves(tree))
    got = TR.param_specs(get_config(arch))
    assert TM.distinct_bytes(got) == want
    assert all(t.device.type == "meta" for t in TM.tensors_of(got))


# -- the step bundles ---------------------------------------------------------


def _close(family, got, want, what):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    kind, tol = TOL[family]
    err = float(np.abs(got - want).max()) if got.size else 0.0
    if kind == "share":
        err /= max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, (what, err)


def _draw(rng, s, *, vocab: int, scale: float):
    """An array for a ShapeDtypeStruct: ints in the vocabulary (0 for a
    0-d int, a cache length the caller sets), floats ``scale * normal``."""
    if np.issubdtype(s.dtype, np.integer):
        if not s.shape:
            return np.zeros((), s.dtype)
        return rng.integers(0, vocab, s.shape).astype(s.dtype)
    return (scale * rng.standard_normal(s.shape)).astype(s.dtype)


def _port_cache(template, jcache):
    """The port cache of ``template``'s type from a JAX cache of the same
    fields (NumPy copies, the length as a host int)."""
    kw = {}
    for f in dataclasses.fields(template):
        t, j = getattr(template, f.name), getattr(jcache, f.name)
        if dataclasses.is_dataclass(t):
            kw[f.name] = _port_cache(t, j)
        elif isinstance(t, torch.Tensor):
            kw[f.name] = torch.from_numpy(np.array(j))
        else:
            kw[f.name] = int(j)
    return dataclasses.replace(template, **kw)


@pytest.fixture(scope="module")
def jtrees(jx):
    """family -> a parameter tree of its reduced config as NumPy, in the
    JAX ``init_params`` tree's shapes and dtypes: matrices ``normal /
    sqrt(rows)``, vectors ``1 + 0.1 * normal`` (the JAX init's own draws
    take seconds to trace, and leave some leaves constant)."""
    jax, cache = jx.jax, {}

    def leaf(rng, s):
        x = rng.standard_normal(s.shape)
        x = x / np.sqrt(s.shape[-2]) if len(s.shape) >= 2 else 1 + 0.1 * x
        return x.astype(s.dtype)

    def get(family):
        if family not in cache:
            model = jx.R.build_model(
                jx.C.get_config(FAMILY_ARCH[family]).reduced())
            rng = np.random.default_rng(7)
            cache[family] = jax.tree_util.tree_map(
                lambda s: leaf(rng, s), jax.eval_shape(
                    lambda: model.init_params(jax.random.PRNGKey(7))))
        return cache[family]
    return get


@pytest.fixture(scope="module")
def jmesh(jx):
    jax = jx.jax
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_step_bundles_match_jax(jx, jmesh, jtrees, family, kind):
    jax, jnp = jx.jax, jx.jnp
    arch = FAMILY_ARCH[family]
    tcfg, jcfg = get_config(arch).reduced(), jx.C.get_config(arch).reduced()
    seq = S_PREFILL if kind == "prefill" else S_SERVE
    tcell = ShapeCell(kind, seq, B, kind)
    jcell = jx.B.ShapeCell(kind, seq, B, kind)
    build_t = TS.build_prefill_step if kind == "prefill" else \
        TS.build_serve_step
    build_j = jx.S.build_prefill_step if kind == "prefill" else \
        jx.S.build_serve_step
    try:
        jb = build_j(jcfg, jcell, jmesh)
        tree = jtrees(family)
        rng = np.random.default_rng(11)
        draw = dict(vocab=jcfg.vocab_size)
        if kind == "prefill":
            arg = {k: _draw(rng, s, scale=0.02, **draw)
                   for k, s in jb.arg_structs[1].items()}
            jcache = jax.tree_util.tree_map(
                lambda s: np.zeros(s.shape, s.dtype), jb.arg_structs[2])
        else:
            arg = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
            jcache = jax.tree_util.tree_map(
                lambda s: _draw(rng, s, scale=1.0, **draw),
                jb.arg_structs[2])
            jcache.length = np.asarray(seq, np.int32)
        with jmesh:
            jl, jc = jax.jit(jb.fn)(jax.tree_util.tree_map(jnp.asarray, tree),
                           jax.tree_util.tree_map(jnp.asarray, arg),
                           jax.tree_util.tree_map(jnp.asarray, jcache))
        jl, jc = np.asarray(jl), jax.tree_util.tree_map(np.asarray, jc)
    finally:
        jx.shard_api.deactivate()
    tb = build_t(tcfg, tcell, impl="chunked", device="cpu")
    params = convert.model_params_from_numpy(tcfg, tree, device="cpu")
    assert _signature(params) == _signature(tb.arg_specs[0])
    if kind == "prefill":
        targ = {k: torch.from_numpy(np.array(v)) for k, v in arg.items()}
    else:
        targ = torch.from_numpy(arg)
    tcache = _port_cache(tb.arg_specs[2], jcache)
    assert _signature(tcache) == _signature(tb.arg_specs[2])
    assert tb.arg_specs[2].length == (0 if kind == "prefill" else seq)
    with torch.no_grad():
        tl, tc = tb.fn(params, targ, tcache)
    _close(family, tl, jl, "logits")
    assert tc.length == int(jc.length)
    for (path, got), (jpath, want) in zip(_leaves(tc), _leaves(jc),
                                          strict=True):
        assert path == jpath
        _close(family, got, want, path)


def test_step_builders_take_the_port_devices():
    cfg = get_config("qwen3-1.7b").reduced()
    cell = ShapeCell("p", 8, 1, "prefill")
    for dev in ("cpu", "meta"):
        bundle = TS.build_prefill_step(cfg, cell, device=dev)
        assert bundle.device.type == dev and bundle.donate_argnums == (2,)
    with pytest.raises(ValueError, match="step device"):
        TS.build_serve_step(cfg, cell, device="mps")
    with pytest.raises(ValueError, match="unknown impl"):
        TS.build_prefill_step(cfg, cell, impl="pallas-ish", device="cpu")


# -- the dry-run's accounting -------------------------------------------------


def _jax_bytes(jx, arch, shape):
    """The JAX package's parameter and input bytes of a cell (a cache's
    int32 length left out: the port keeps it on the host)."""
    jax = jx.jax
    cfg = jx.C.get_config(arch)
    model = jx.R.build_model(cfg)
    params = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    specs = jx.R.input_specs(cfg, jx.B.SHAPE_CELLS[shape])
    return (sum(x.size * x.dtype.itemsize
                for x in jax.tree_util.tree_leaves(params)),
            sum(v.size * v.dtype.itemsize for _, v in _leaves(specs)))


@pytest.mark.parametrize("arch,shape,input_gb,fits", [
    ("qwen3-1.7b", "decode_32k", 484.8, False),
    ("rwkv6-1.6b", "long_500k", 0.01, True)])
def test_run_cell_at_published_widths(jx, arch, shape, input_gb, fits):
    rec = TD.run_cell(arch, shape)
    params, inputs = _jax_bytes(jx, arch, shape)
    assert rec["ok"] and rec["device"] == "meta"
    assert rec["param_bytes"] == params and rec["input_bytes"] == inputs
    assert round(rec["input_bytes"] / 1e9, 2 if input_gb < 1 else 1) == \
        input_gb
    assert rec["total_bytes"] == (rec["param_bytes"] + rec["input_bytes"]
                                  + rec["peak_temp_bytes"])
    assert rec["fits_one_card"] is fits
    assert rec["flops"] > 0 and rec["peak_temp_bytes"] > 0
    cut = rec["cut"]
    assert cut["total_bytes"] <= H100.hbm_bytes
    assert cut["num_layers"] == get_config(arch).num_layers
    if fits:
        assert cut["global_batch"] == SHAPE_CELLS[shape].global_batch
    else:
        assert 1 <= cut["global_batch"] < SHAPE_CELLS[shape].global_batch


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_run_cell_at_reduced_widths(family):
    """Each family's prefill and decode cells, whole; the train cells'
    steps (~5 s each at 256 x 4096 on meta: their chunk loops run under
    autograd, every iteration) in ``test_train_step_on_meta``."""
    arch = FAMILY_ARCH[family]
    for shape in cells_for(arch)[1:]:
        rec = TD.run_cell(arch, shape, reduced=True)
        cell = SHAPE_CELLS[shape]
        assert rec["ok"] and rec["reduced"] and rec["flops"] > 0, shape
        assert rec["param_bytes"] == TM.distinct_bytes(
            TR.param_specs(get_config(arch).reduced())), shape
        assert rec["total_bytes"] == sum(rec.get(k, 0) for k in (
            "param_bytes", "opt_state_bytes", "input_bytes",
            "peak_temp_bytes")), shape
        assert rec["fits_one_card"] == (rec["total_bytes"]
                                        <= H100.hbm_bytes), shape
        assert rec["cut"]["total_bytes"] <= H100.hbm_bytes, shape
        assert rec["cut"]["global_batch"] <= cell.global_batch, shape


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_train_step_on_meta(family):
    """``build_train_step`` (microbatches, the backward, AdamW) on meta
    at reduced widths for every family, at a 256-token sequence: bytes
    and FLOPs, and the train record's fields."""
    cfg = get_config(FAMILY_ARCH[family]).reduced()
    cell = dataclasses.replace(SHAPE_CELLS["train_4k"], seq_len=256,
                               global_batch=16)
    rec = TD.account(cfg, cell)
    params = rec["param_bytes"]
    assert rec["opt_state_bytes"] == 2 * 4 * sum(
        t.numel() for t in TM.tensors_of(TR.param_specs(cfg))) + 4
    # the loss and AdamW's new step count; the rest is written in place
    assert rec["output_new_bytes"] == 8
    assert rec["peak_temp_bytes"] > params and rec["flops"] > 0
    assert rec["total_bytes"] == (params + rec["opt_state_bytes"]
                                  + rec["input_bytes"]
                                  + rec["peak_temp_bytes"])


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_find_cut_against_brute_force(kind):
    """The cut is the largest batch whose own meta pass fits the budget,
    and at batch 1 the largest depth, as trying every one says."""
    cfg = get_config("qwen3-1.7b").reduced()
    cfg = dataclasses.replace(cfg, num_layers=5, train_microbatches=2)
    step = 2 if kind == "train" else 1
    cell = ShapeCell(kind, 32, 6 * step, kind)

    def total(batch, layers):
        c = dataclasses.replace(cell, global_batch=batch)
        return TD.account(TD.depth_cut(cfg, layers), c)["total_bytes"]

    by_batch = [total(k * step, 5) for k in range(1, 7)]
    assert by_batch == sorted(by_batch)
    budget = (by_batch[3] + by_batch[4]) // 2
    cut = TD.find_cut(cfg, cell, by_batch[-1], budget=budget)
    assert cut == {"global_batch": 4 * step, "num_layers": 5,
                   "total_bytes": by_batch[3]}
    by_depth = [total(step, n) for n in range(1, 6)]
    budget = (by_depth[2] + by_depth[3]) // 2
    cut = TD.find_cut(cfg, cell, by_batch[-1], budget=budget)
    assert cut == {"global_batch": step, "num_layers": 3,
                   "total_bytes": by_depth[2]}
    assert TD.find_cut(cfg, cell, by_batch[-1], budget=by_depth[0] - 1) \
        is None
    whole = TD.find_cut(cfg, cell, by_batch[-1], budget=by_batch[-1])
    assert whole["global_batch"] == cell.global_batch


@pytest.mark.parametrize("family,kind", [
    ("dense", "decode"), ("moe", "prefill"), ("vlm", "decode"),
    ("ssm", "prefill"), ("hybrid", "decode"), ("audio", "prefill")])
def test_card_compare_on_cpu(monkeypatch, family, kind):
    """``card_compare`` on the CPU at reduced widths, a short cell (each
    family once, each kind three times): the kernel routes there take the
    kernels' plain versions, so the kernel step meets the plain step
    within ``STEP_RTOL``; what each step wrote is the logits and every
    cache leaf on the plain step's rows, and ``again`` hands a decode
    step's recurrent states back as they were before the first step."""
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    cfg = get_config(FAMILY_ARCH[family]).reduced()
    cell = ShapeCell(kind, 64, 2, kind)
    g = torch.Generator()
    g.manual_seed(0)
    bundle = TD.cell_bundle(cfg, cell, impl="kernel", device="cpu")
    args = TD.card_args(cfg, bundle, cell, g)
    states = {k: t.clone() for k, t in
              TD.written(args[2], cell, states=True).items()}
    both = TD.card_compare(cfg, cell, args, device="cpu")
    rows = 1 if kind == "prefill" else 2
    assert both["rows"] == rows
    assert set(both["got"]) == set(both["want"]) == set(both["rel_rms"])
    leaves = TD.written(TR.build_model(cfg).init_cache(
        2, 64 + TR.DECODE_SLACK, device="cpu",
        **({"enc_len": 64} if family == "audio" else {})), cell, rows)
    assert set(both["got"]) == {"logits", *leaves}
    assert both["got"]["logits"].shape[0] == rows
    assert max(both["rel_rms"].values()) <= TD.STEP_RTOL, both["rel_rms"]
    if kind == "decode":
        both["again"]()
        for k, t in TD.written(args[2], cell, states=True).items():
            assert torch.equal(t, states[k]), k


@pytest.mark.parametrize("arch,shape,seq,batch", [
    ("qwen3-1.7b", "prefill_32k", 4096, 8),
    ("rwkv6-1.6b", "prefill_32k", 2048, 8),
    ("zamba2-7b", "prefill_32k", 2048, 8),
    ("seamless-m4t-large-v2", "prefill_32k", 4096, 8),
    ("qwen3-1.7b", "train_4k", 256, 8), ("zamba2-7b", "train_4k", 512, 2)])
def test_meta_loops_count_as_every_iteration(monkeypatch, arch, shape, seq,
                                             batch):
    """A pass whose loops stand a representative in for repeated
    iterations counts what the pass that runs every iteration counts:
    without autograd (a prefill; a train step's microbatches, each done
    before the next) the bytes held, the FLOPs, the bytes accessed and the
    transcendentals exactly; where a checkpointed SSD chunk stands in
    (zamba2's train step), the bytes held within 1e-6 and the three cost
    counts within 1% (its backward recomputes the whole chunk, where
    checkpoint's early stop leaves out the last products)."""
    cfg = get_config(arch).reduced()
    cell = dataclasses.replace(SHAPE_CELLS[shape], seq_len=seq,
                               global_batch=batch)
    fast = TD.account(cfg, cell)
    monkeypatch.setattr(TM, "loop_repeats",
                        lambda n, t, **kw: [1] * n)
    for mod in ("repro_torch.models.attention", "repro_torch.models.mamba2",
                "repro_torch.kernels.linear_scan",
                "repro_torch.launch.steps"):
        monkeypatch.setattr(f"{mod}.loop_repeats", TM.loop_repeats)
    full = TD.account(cfg, cell)
    checkpointed = arch == "zamba2-7b" and cell.kind == "train"
    for k in ("param_bytes", "input_bytes", "output_bytes",
              "peak_temp_bytes", "total_bytes"):
        if checkpointed:
            assert abs(fast[k] - full[k]) <= 1e-6 * full[k], k
        else:
            assert fast[k] == full[k], k
    for k in ("flops", "bytes_accessed", "transcendentals"):
        assert full[k] > 0, k
        if checkpointed:
            assert abs(fast[k] - full[k]) <= 0.01 * full[k], k
        else:
            assert fast[k] == full[k], k


def _xla_cost(jx, fn, x):
    cost = jx.jax.jit(fn).lower(x).compile().cost_analysis()
    return cost[0] if isinstance(cost, (list, tuple)) else cost


@pytest.mark.parametrize("name", ["exp", "softmax", "rms_norm", "silu"])
def test_meta_pass_transcendentals_match_xla(jx, name):
    """On ``[64, 128]`` float32, ``MetaPass``'s transcendentals of the
    port's function equal XLA's ``cost_analysis()`` of the JAX one: one a
    element for exp, softmax and silu, one rsqrt a row for the rms norm
    (the port's ``layers.rms_norm`` against the JAX package's)."""
    import torch.nn.functional as F
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    jnp, nn = jx.jnp, jx.jax.nn
    want = {"exp": 8192, "softmax": 8192, "rms_norm": 64, "silu": 8192}
    port = {"exp": torch.exp, "softmax": lambda x: torch.softmax(x, -1),
            "rms_norm": lambda x: TL.rms_norm(x, torch.ones(128,
                                                            device="meta")),
            "silu": F.silu}[name]
    ref = {"exp": jnp.exp, "softmax": lambda x: nn.softmax(x, axis=-1),
           "rms_norm": lambda x: JL.rms_norm(x, jnp.ones((128,))),
           "silu": nn.silu}[name]
    xla = _xla_cost(jx, ref, jnp.ones((64, 128), jnp.float32))
    x = torch.empty((64, 128), device="meta")
    watch = TM.MetaPass(exclude=(x,))
    with watch:
        port(x)
    assert watch.transcendentals == int(xla["transcendentals"]) \
        == want[name]
    if name == "exp":       # one op: XLA's bytes too
        assert watch.bytes_accessed == int(xla["bytes accessed"]) == 65536


def test_meta_pass_bytes_accessed():
    """A view moves nothing; a product reads its two operands and writes
    its output; an in-place op reads and writes its tensor; a memoised
    repeat and ``repeated(n)`` count as the runs they stand for."""
    x = torch.empty((64, 128), device="meta")
    w = torch.empty((128, 32), device="meta")
    watch = TM.MetaPass(exclude=(x, w))
    with watch:
        x.view(128, 64).t()
        assert watch.bytes_accessed == 0
        y = x @ w
        assert watch.bytes_accessed == 4 * (64 * 128 + 128 * 32 + 64 * 32)
        y.add_(1.0)
        assert watch.bytes_accessed == 4 * (64 * 128 + 128 * 32 + 3 * 64 * 32)
    before = watch.bytes_accessed, watch.flops
    with watch, TM.repeated(3):
        x @ w
    assert watch.bytes_accessed - before[0] == 3 * 4 * (64 * 128 + 128 * 32
                                                        + 64 * 32)
    assert watch.flops - before[1] == 3 * 2 * 64 * 128 * 32


def test_meta_pass_counts_views_and_in_place_writes_as_nothing():
    x = torch.empty((4, 1024), device="meta")
    watch = TM.MetaPass(exclude=(x,))
    with watch:
        x[0].add_(1.0)              # in place into an argument
        y = x.view(1024, 4)         # a view of it
        z = torch.exp(x) @ y        # 16 KB, then 64 B
        del z
        w = torch.exp(x)
        assert watch.now == 16384
    assert watch.peak == 16384 + 64 and watch.flops == 2 * 4 * 1024 * 4
    del w, y
