"""Logical-axis sharding rules -> PartitionSpecs for params, batches and
caches, and the fleet mesh that splits the fleet tick's lanes.

The port of the JAX package's ``sharding/partition.py``, without JAX.

Mesh axes:
  pod    (multi-pod only)  composes with `data` into the DP/FSDP axis
  data   DP: batch dims; FSDP: the d_model-ish dim of every weight
  model  TP: heads / d_ff / vocab / experts; SP: decode KV sequence

A mesh is anything with ``.axis_names`` and a ``.shape`` mapping from name
to size: the port's ``AbstractMesh`` (sizes and names, no devices, so the
specs of a 256- or 512-card mesh are computed on one machine) or a
``torch.distributed.device_mesh.DeviceMesh`` (read through ``mesh_axes``:
``mesh_dim_names`` and ``size(i)``).

Rules are name-based over the parameter tree, walked by key path as
``tree_map_with_path`` walks it; the port's trees use the JAX tree's names
and layouts, so the table applies unchanged:

  name                      layout                     spec (L = scan dim)
  embed                     [V, D]                     (model, fsdp)*
  lm_head                   [D, V]                     (fsdp, model)*
  wq|wk|wv|wg|wr|w_gate|w_up|cm_wk|cm_wr|in_proj|mix_down|w_down(lora)
                            [L, D, out]                (None, fsdp, model)
  wo|w_down|cm_wv|out_proj  [L, in, D]                 (None, model, fsdp)
  moe router                [L, D, E]                  (None, fsdp, None)
  moe w_gate|w_up           [L, E, D, F]   EP          (None, model, fsdp, None)
  moe w_down                [L, E, F, D]   EP          (None, model, None, fsdp)
  conv_w                    [L, K, C]                  (None, None, model)
  lora qa|ka|va             [I, D, r]                  (None, fsdp, None)
  lora qb|kb|vb             [I, r, out]                (None, None, model)
  norms / scalars           replicated

  (*) vocab falls back to replicated when V % model != 0.

Every rule checks divisibility and drops the axis if it doesn't divide.
Only dict keys name a leaf: the fields of a cache (``KVCache``,
``RWKVState``, ...) are positions, as the JAX caches' children are (they
flatten without keys), so a cache leaf's name is ``""`` there and here.

``logical_to_sharding`` turns a spec into a ``NamedSharding``: the spec,
and the DTensor placements on a mesh's dimensions (one ``Shard(d)`` or
``Replicate()`` a mesh dimension; two mesh axes on one tensor dimension
split it major-to-minor in the mesh's order, the order of JAX's
``P(("pod", "data"))``), plus the local block a mesh coordinate holds.

The fleet side: ``FleetMesh`` is one ``"cams"`` axis over a list of
``torch.device``s; ``shard_fleet_tick`` cuts every operand's lane axis
into the mesh's equal contiguous chunks (``fleet_sharding``), runs the
per-lane tick on each chunk on that chunk's device and returns each
output as a ``LaneChunks`` (the chunks, left where they were computed).
Lanes are independent, so no collective is needed and no value changes.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["PartitionSpec", "AbstractMesh", "NamedSharding", "mesh_axes",
           "param_specs", "batch_specs", "cache_specs", "fsdp_axes",
           "dp_size", "shardings_for", "opt_state_specs",
           "logical_to_sharding", "logits_spec", "sequence_axis",
           "spec_leaves",
           "map_specs", "LeafPlan", "leaf_plans", "FleetMesh", "fleet_mesh", "padded_lane_count",
           "LaneSharding", "fleet_sharding", "LaneChunks",
           "shard_fleet_tick", "rec_map"]


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh axis name, a tuple of names,
    or ``None`` (replicated).  Dimensions past the last entry are
    replicated, as in JAX, and a tuple of one name is that name (JAX
    normalizes ``("data",)`` to ``"data"``)."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return tuple(e)[0] if len(e) == 1 else (tuple(e) or None)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(tuple(self))


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names, no devices (JAX's ``AbstractMesh``)."""
    axis_sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.axis_sizes} against names "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_axes(mesh) -> Any:
    """``mesh`` as something with ``.axis_names`` and a ``.shape`` dict: a
    ``DeviceMesh`` becomes the ``AbstractMesh`` of its names and sizes,
    anything else is returned as it is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and not hasattr(mesh, "axis_names"):
        return AbstractMesh(tuple(mesh.size(i) for i in range(len(names))),
                            tuple(names))
    return mesh


def _dp(mesh, cfg=None) -> tuple:
    names = ("pod", "data", "model") if (cfg is not None and cfg.zero3) \
        else ("pod", "data")
    return tuple(n for n in names if n in mesh.axis_names)


def fsdp_axes(mesh, cfg) -> tuple:
    """The DP/FSDP axis (composes pod+data on multi-pod meshes; zero3 mode
    folds the model axis in too)."""
    return _dp(mesh_axes(mesh), cfg)


def _size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def dp_size(mesh, cfg) -> int:
    """The product of ``dp_axes``' sizes (the JAX train step's DP size)."""
    mesh = mesh_axes(mesh)
    return _size(mesh, _dp(mesh, cfg))


def _maybe(mesh, dim: int, axes):
    """axes if they divide dim, else None (replicate)."""
    if axes is None:
        return None
    sz = _size(mesh, axes)
    return axes if (sz > 0 and dim % sz == 0) else None


def _best_prefix(mesh, dim: int, axes):
    """Longest prefix of ``axes`` whose size divides dim (zero3 multi-pod:
    batch 256 can't shard 512 ways -- fall back to (pod, data))."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    for k in range(len(axes), 0, -1):
        sub = axes[:k]
        if dim % _size(mesh, sub) == 0:
            return sub
    return None


# -----------------------------------------------------------------------------
# trees by key path
# -----------------------------------------------------------------------------


def _shape(leaf) -> tuple:
    """A leaf's shape; a host scalar (a cache's ``length``) is 0-d."""
    return tuple(getattr(leaf, "shape", ()))


def _map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over nested dicts and dataclasses.  A dict key
    enters the path as its name (a ``str``), a dataclass field as its
    position (an ``int``): JAX's ``DictKey`` and ``SequenceKey``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = dataclasses.fields(tree)
        return dataclasses.replace(tree, **{
            f.name: _map_with_path(fn, getattr(tree, f.name), path + (i,))
            for i, f in enumerate(fields)})
    return fn(path, tree)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _path_names(path) -> list[str]:
    return [e for e in path if isinstance(e, str)]


def map_specs(fn: Callable, specs: Any) -> Any:
    """``fn(spec)`` over a tree of ``PartitionSpec`` leaves (nested dicts,
    dataclasses and tuples)."""
    if isinstance(specs, PartitionSpec):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, tuple):
        return tuple(map_specs(fn, v) for v in specs)
    if dataclasses.is_dataclass(specs) and not isinstance(specs, type):
        return dataclasses.replace(specs, **{
            f.name: map_specs(fn, getattr(specs, f.name))
            for f in dataclasses.fields(specs)})
    return fn(specs)


def spec_leaves(specs: Any) -> list:
    """The leaves of a spec tree in JAX's leaf order: dict keys sorted,
    dataclass fields in order."""
    if isinstance(specs, (PartitionSpec, NamedSharding)) or specs is None:
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, tuple):
        return [x for v in specs for x in spec_leaves(v)]
    if dataclasses.is_dataclass(specs) and not isinstance(specs, type):
        return [x for f in dataclasses.fields(specs)
                for x in spec_leaves(getattr(specs, f.name))]
    return [specs]


# -----------------------------------------------------------------------------
# parameters
# -----------------------------------------------------------------------------

# leaf-name -> (in_axis_role, out_axis_role); roles: fsdp | model | none
_COL_PARALLEL = re.compile(
    r"^(wq|wk|wv|wg|wr|w_gate|w_up|cm_wk|cm_wr|in_proj|mix_down|w_down_lora)$")
_ROW_PARALLEL = re.compile(r"^(wo|w_down|cm_wv|out_proj)$")


def param_specs(params_shape: Any, cfg, mesh):
    """PartitionSpec tree matching the parameter tree (tensors of any
    device, the meta ``registry.param_specs`` included)."""
    mesh = mesh_axes(mesh)
    fsdp = _dp(mesh, cfg) if cfg.fsdp else None
    model = "model" if "model" in mesh.axis_names else None

    if cfg.zero3:
        model = None                      # no tensor parallelism

    def spec(path, leaf) -> PartitionSpec:
        names = _path_names(path)
        name = _leaf_name(path)
        shape = _shape(leaf)
        nd = len(shape)
        in_moe = "moe" in names
        # --- embeddings ------------------------------------------------------
        if name == "embed":
            v, d = shape
            return P(_maybe(mesh, v, model), _maybe(mesh, d, fsdp))
        if name == "lm_head":
            d, v = shape
            return P(_maybe(mesh, d, fsdp), _maybe(mesh, v, model))
        # --- MoE expert weights [L, E, D, F] / [L, E, F, D] -------------------
        if in_moe and name in ("w_gate", "w_up", "w_down") and nd == 4:
            _, e, a, b = shape
            if cfg.moe_parallel == "ep":
                espec = _maybe(mesh, e, model)
                if name == "w_down":    # [L, E, F, D]
                    return P(None, espec, None, _maybe(mesh, b, fsdp))
                return P(None, espec, _maybe(mesh, a, fsdp), None)
            if name == "w_down":        # TP inside experts, [L, E, F, D]
                return P(None, None, _maybe(mesh, a, model),
                         _maybe(mesh, b, fsdp))
            return P(None, None, _maybe(mesh, a, fsdp),
                     _maybe(mesh, b, model))
        if in_moe and name == "router":  # [L, D, E]
            return P(None, _maybe(mesh, shape[1], fsdp), None)
        # --- zamba LoRA stacks [I, D, r] / [I, r, out] ------------------------
        if name in ("qa", "ka", "va"):
            return P(None, _maybe(mesh, shape[1], fsdp), None)
        if name in ("qb", "kb", "vb"):
            return P(None, None, _maybe(mesh, shape[2], model))
        # --- mamba conv [L, K, C] ---------------------------------------------
        if name == "conv_w":
            return P(*([None] * (nd - 1)), _maybe(mesh, shape[-1], model))
        # --- generic col/row parallel (leading scan dims allowed) -------------
        # Under sequence parallelism, attention weights drop the model axis
        # only when the head count doesn't divide it (phi3: 40H vs 16).
        attn_names = ("wq", "wk", "wv", "wo")
        msize = _size(mesh, model)
        sp_attn = (cfg.sequence_parallel and name in attn_names
                   and cfg.num_heads % max(msize, 1) != 0)
        if _COL_PARALLEL.match(name) and nd >= 2:
            lead = [None] * (nd - 2)
            return P(*lead, _maybe(mesh, shape[-2], fsdp),
                     None if sp_attn else _maybe(mesh, shape[-1], model))
        if _ROW_PARALLEL.match(name) and nd >= 2:
            lead = [None] * (nd - 2)
            return P(*lead, None if sp_attn else _maybe(mesh, shape[-2], model),
                     _maybe(mesh, shape[-1], fsdp))
        # JAX's two fallthrough rules after these: ``w_down`` and ``w_up``
        # never reach them (the patterns above take both), so only
        # ``mix_up`` does: (..., None, model)
        if name == "mix_up" and nd >= 2:
            lead = [None] * (nd - 2)
            return P(*lead, None, _maybe(mesh, shape[-1], model))
        # --- everything else (norms, scalars, biases, u, A_log, ...) ----------
        return P()

    return _map_with_path(spec, params_shape)


# the top-level keys whose leaves stack layers on a leading axis
STACKED = ("layers", "encoder", "decoder", "mamba", "mamba_norm", "lora")


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How a parameter leaf is split, for a rank that computes on its
    block: the dimension the DP/FSDP axes split (``dp_dim``, gathered
    over the rank's DP group where the leaf is used) and the one the model
    axis splits (``model_dim``, kept: the layer computes on it), each
    ``None`` where the spec leaves the leaf whole.  A layer's leaf is
    planned without its ``[L]`` axis."""
    dp_dim: "int | None"
    model_dim: "int | None"


def leaf_plans(params_shape: Any, cfg, mesh) -> dict:
    """``{path: LeafPlan}`` of every parameter leaf by ``param_specs`` on
    ``mesh``: a path is the leaf's dict keys, and a leaf of a stack of
    layers (under one of ``STACKED``: the transformer's and rwkv6's
    ``layers``, enc-dec's ``encoder`` / ``decoder``, zamba2's ``mamba``,
    ``mamba_norm`` and per-invocation ``lora``) is planned for one layer
    (its dims one lower)."""
    mesh = mesh_axes(mesh)
    dp = set(_dp(mesh, cfg))
    plans = {}

    def plan(path, spec):
        names = _path_names(path)
        lead = 1 if names and names[0] in STACKED else 0
        dp_dim = model_dim = None
        for d, entry in enumerate(spec):
            axes = set(_axes_of(entry))
            if not axes:
                continue
            if axes == {"model"} and not cfg.zero3:
                model_dim = d - lead
            elif axes == dp:
                dp_dim = d - lead
            else:
                raise NotImplementedError(
                    f"{'/'.join(names)}: spec {spec} splits a dim over "
                    f"{sorted(axes)}, neither the model axis nor the DP "
                    f"axes {sorted(dp)}")
        plans[tuple(names)] = LeafPlan(dp_dim, model_dim)
        return spec

    _map_with_path(plan, param_specs(params_shape, cfg, mesh))
    return plans


def opt_state_specs(params_shape: Any, cfg, mesh):
    """Adam m/v mirror the parameter sharding; counters replicated."""
    pspecs = param_specs(params_shape, cfg, mesh)
    return {"m": pspecs, "v": pspecs, "count": P()}


# -----------------------------------------------------------------------------
# batches and caches
# -----------------------------------------------------------------------------


def batch_specs(batch_shape: dict, cfg, mesh, cell=None):
    """The batch dim over the longest divisible prefix of the DP axes;
    sequence and features replicated."""
    mesh = mesh_axes(mesh)
    dp = _dp(mesh, cfg)

    def spec(path, leaf):
        shape = _shape(leaf)
        lead = _best_prefix(mesh, shape[0], dp)
        return P(lead, *([None] * (len(shape) - 1)))

    return _map_with_path(spec, batch_shape)


_KV_NAMES = ("k", "v", "self_k", "self_v", "cross_k", "cross_v", "attn_k",
             "attn_v")


def cache_specs(cache_shape: Any, cfg, mesh, cell=None):
    """KV/state cache sharding for decode cells.

    Layouts handled:
      [L, B, S, KH, HD]  kv cache      -> B: dp, S: model  (flash-decode SP)
      [B, S, D]          enc_out       -> B: dp
      [L, B, H, K, V]    wkv/ssm state -> B: dp, H: model
      [L, B, K-1, C]     conv state    -> B: dp, C: model
      [L, B, D]          shift state   -> B: dp
      scalars            replicated

    When B < dp size (long_500k has B=1), B falls back to replicated and
    the sequence (or head) dim keeps the model axis.  A cache's fields are
    unnamed (see the module docstring), so the named rows apply only to a
    dict of leaves.
    """
    mesh = mesh_axes(mesh)
    dp = _dp(mesh, cfg)
    model = ("model" if "model" in mesh.axis_names and not cfg.zero3
             else None)

    def spec(path, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 0 or max(shape) == 1 and nd <= 1:
            return P()
        name = _leaf_name(path)
        if nd == 5:   # [L, B, S, KH, HD] kv cache or [L, B, H, K, V] state
            _, b, s, _, _ = shape
            bspec = _maybe(mesh, b, dp)
            if name in _KV_NAMES and bspec is None:
                return P(None, None, _maybe(mesh, s, model), None, None)
            return P(None, bspec, _maybe(mesh, s, model), None, None)
        if nd == 4:   # [L, B, H, P*N...] / [L, B, K-1, C] conv
            _, b, _, c = shape
            return P(None, _maybe(mesh, b, dp), None,
                     _maybe(mesh, c, model))
        if nd == 3:   # [B, S, D] enc_out / [L, B, D] shifts
            a, b, _ = shape
            if name == "enc_out":
                return P(_maybe(mesh, a, dp), None, None)
            return P(None, _maybe(mesh, b, dp), None)
        if nd == 2:
            return P(_maybe(mesh, shape[0], dp), None)
        return P()

    return _map_with_path(spec, cache_shape)


def sequence_axis(cfg, mesh, batch: int, seq: int):
    """The mesh axis JAX's ``shard(h, "dp", "model", None)`` puts the
    sequence of a ``[batch, seq, D]`` residual stream on under the
    ``sequence_parallel`` hint: ``"model"`` where the mesh has that axis
    and ``seq`` divides it, else ``None`` (no hint, no axis, or the dim
    left whole).  Raises ``ValueError`` where the batch's DP axes take the
    model axis as well (``zero3``, whose DP axes end in it, and a batch
    that divides all of them): JAX's constraint names the axis twice
    there and raises ``DuplicateSpecError``."""
    mesh = mesh_axes(mesh)
    if not cfg.sequence_parallel or "model" not in mesh.axis_names \
            or seq % mesh.shape["model"]:
        return None
    lead = _best_prefix(mesh, batch, _dp(mesh, cfg))
    if lead is not None and "model" in lead:
        raise ValueError(
            f"sequence_parallel under zero3: the batch of {batch} splits "
            f"over {lead}, the model axis among them, and the hint puts "
            f"the sequence of {seq} on the model axis too (JAX's spec "
            f"({lead}, 'model', None) names it twice: DuplicateSpecError)")
    return "model"


def logits_spec(logits_shape, cfg, mesh) -> PartitionSpec:
    """The serving logits ``[B, S, V]``: the batch over the DP axes and the
    vocab over ``model`` where each divides (JAX ``steps._logits_spec``)."""
    mesh = mesh_axes(mesh)
    b, _, v = tuple(getattr(logits_shape, "shape", logits_shape))
    dp = _dp(mesh, cfg)
    bspec = dp if b % _size(mesh, dp) == 0 else None
    vspec = ("model" if not cfg.zero3 and v % mesh.shape["model"] == 0
             else None)
    return P(bspec, None, vspec)


# -----------------------------------------------------------------------------
# specs -> placements on a device mesh
# -----------------------------------------------------------------------------


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the DTensor placements (one a mesh dimension) and
    the block of a tensor each mesh coordinate holds."""
    mesh: Any
    spec: PartitionSpec

    def __post_init__(self):
        names = tuple(mesh_axes(self.mesh).axis_names)
        seen = []
        for entry in self.spec:
            axes = _axes_of(entry)
            for a in axes:
                if a not in names:
                    raise ValueError(f"spec {self.spec}: no mesh axis {a!r} "
                                     f"in {names}")
                if a in seen:
                    raise ValueError(f"spec {self.spec}: axis {a!r} twice")
                seen.append(a)
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                # a DTensor splits a dim over mesh dims in the mesh's order
                raise ValueError(f"spec {self.spec}: axes {axes} out of the "
                                 f"mesh's order {names}")

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(mesh_axes(self.mesh).axis_names)
        out = [Replicate() for _ in names]
        for d, entry in enumerate(self.spec):
            for a in _axes_of(entry):
                out[names.index(a)] = Shard(d)
        return tuple(out)

    def _split(self, d: int, coord: "dict[str, int]") -> tuple[int, int]:
        """(block index, block count) of tensor dim ``d`` at ``coord``."""
        mesh = mesh_axes(self.mesh)
        idx, count = 0, 1
        if d < len(self.spec):
            for a in _axes_of(self.spec[d]):
                idx = idx * mesh.shape[a] + coord[a]
                count *= mesh.shape[a]
        return idx, count

    def local_shape(self, shape) -> tuple:
        """The block shape every coordinate holds (dims divide exactly)."""
        out = []
        for d, n in enumerate(shape):
            _, count = self._split(d, {a: 0 for a in
                                       mesh_axes(self.mesh).axis_names})
            if n % count:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"{count} ways ({self.spec})")
            out.append(n // count)
        return tuple(out)

    def local_block(self, x: torch.Tensor, coord) -> torch.Tensor:
        """The block of the whole tensor ``x`` held at mesh coordinate
        ``coord`` (a tuple in the mesh's axis order, or a name -> index
        dict): a view of ``x``."""
        names = tuple(mesh_axes(self.mesh).axis_names)
        if not isinstance(coord, dict):
            coord = dict(zip(names, coord))
        shape = self.local_shape(x.shape)
        for d, n in enumerate(shape):
            idx, count = self._split(d, coord)
            if count > 1:
                x = x.narrow(d, idx * n, n)
        return x

    def distribute(self, x: torch.Tensor):
        """A ``DTensor`` over this sharding's ``DeviceMesh`` holding, on
        this rank, a copy of its block of the whole tensor ``x`` (every rank
        passes the same ``x``; nothing is communicated)."""
        from torch.distributed.tensor import DTensor
        block = self.local_block(x, tuple(self.mesh.get_coordinate()))
        return DTensor.from_local(block.contiguous().clone(), self.mesh,
                                  self.placements, run_check=False,
                                  shape=x.shape, stride=x.contiguous().stride())


def logical_to_sharding(specs: Any, mesh):
    """Every ``PartitionSpec`` of ``specs`` as a ``NamedSharding`` on
    ``mesh``."""
    return map_specs(lambda s: NamedSharding(mesh, s), specs)


def shardings_for(tree_shape: Any, specs: Any, mesh):
    """JAX's signature over ``logical_to_sharding``: ``tree_shape`` is not
    read (the specs carry the tree's structure)."""
    return logical_to_sharding(specs, mesh)


# -----------------------------------------------------------------------------
# fleet control plane (camera-axis data parallelism)
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """One ``"cams"`` axis over ``devices`` (repeats allowed: a split of
    the lanes over one device runs the chunks one after another)."""
    devices: tuple
    axis_names: tuple = ("cams",)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def fleet_mesh(devices=None) -> FleetMesh:
    """One-axis ``("cams",)`` mesh for the fleet control plane.

    ``devices`` is a ``FleetMesh`` (used as given -- must carry a ``cams``
    axis), an int ``k`` (``cuda:0 .. cuda:k-1``; raises when fewer CUDA
    devices are present), an explicit device sequence (taken as given,
    repeats allowed: ``["cpu"] * 8`` splits the lanes eight ways on the
    CPU), or None (every CUDA device; raises when there is none).  A CUDA
    device is never replaced by the CPU.
    """
    if isinstance(devices, FleetMesh):
        if "cams" not in devices.axis_names:
            raise ValueError("fleet mesh needs a 'cams' axis, got "
                             f"{devices.axis_names}")
        return devices
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if devices is None:
        if avail == 0:
            raise RuntimeError("fleet_mesh(): no CUDA device is present; "
                               "pass the devices (e.g. ['cpu'] * k)")
        devs = [torch.device("cuda", i) for i in range(avail)]
    elif isinstance(devices, int):
        if not 1 <= devices <= avail:
            raise ValueError(f"mesh wants {devices} CUDA devices but "
                             f"{avail} are present")
        devs = [torch.device("cuda", i) for i in range(devices)]
    else:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("fleet_mesh: an empty device sequence")
    return FleetMesh(tuple(devs))


def padded_lane_count(n: int, mesh: "FleetMesh | None") -> int:
    """Smallest lane count >= n divisible by the mesh's device count."""
    if mesh is None:
        return n
    m = mesh.size
    return -(-n // m) * m


def rec_map(fn: Callable, rec: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a record (a dataclass of tensors or arrays,
    nested dataclasses allowed) and of the records in ``rest``."""
    if dataclasses.is_dataclass(rec) and not isinstance(rec, type):
        return type(rec)(**{
            f.name: rec_map(fn, getattr(rec, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(rec)})
    return fn(rec, *rest)


def _rec_first(rec: Any):
    """The first leaf of a record."""
    while dataclasses.is_dataclass(rec) and not isinstance(rec, type):
        rec = getattr(rec, dataclasses.fields(rec)[0].name)
    return rec


@dataclasses.dataclass(frozen=True)
class LaneSharding:
    """The lane axis of every fleet tick operand over a ``FleetMesh``:
    equal contiguous chunks, chunk ``i`` on ``mesh.devices[i]``."""
    mesh: FleetMesh

    def bounds(self, n: int) -> list[tuple[int, int]]:
        k = self.mesh.size
        if n % k:
            raise ValueError(f"{n} lanes do not split over {k} devices "
                             "(pad with padded_lane_count)")
        c = n // k
        return [(i * c, (i + 1) * c) for i in range(k)]

    def owner(self, lane: int, n: int) -> tuple[int, int]:
        """(chunk, offset in the chunk) of ``lane`` among ``n``."""
        c = n // self.mesh.size
        return lane // c, lane % c

    def runs(self) -> list[tuple[torch.device, int, int]]:
        """(device, first chunk, end chunk) of each maximal run of
        consecutive chunks on one device."""
        out = []
        for i, d in enumerate(self.mesh.devices):
            if out and out[-1][0] == d:
                out[-1] = (d, out[-1][1], i + 1)
            else:
                out.append((d, i, i + 1))
        return out

    def split(self, record: Any) -> "LaneChunks":
        """A whole record (tensors or NumPy arrays, the lane axis at dim 0)
        cut into chunks, each on its device: each run of consecutive
        chunks on one device gets one copy of its own lanes there and its
        chunks are views of that copy (a split of one card copies each
        leaf once; a device holds no other device's lanes)."""
        n = _rec_first(record).shape[0]
        bounds = self.bounds(n)
        runs = self.runs()

        def cut(x):
            x = torch.as_tensor(x)
            chunks = []
            for d, i, j in runs:
                lo, hi = bounds[i][0], bounds[j - 1][1]
                block = (x if hi - lo == n else x[lo:hi]).to(d)
                chunks += ([block] if j - i == 1 else
                           [block[a - lo:b - lo] for a, b in bounds[i:j]])
            return chunks

        leaves = rec_map(cut, record)
        return LaneChunks(self, [rec_map(lambda xs, i=i: xs[i], leaves)
                                 for i in range(len(bounds))], n_padded=n)


def fleet_sharding(mesh: FleetMesh) -> LaneSharding:
    """Which lanes live on which device: dim 0 of every fleet tick operand
    in equal contiguous chunks, chunk ``i`` on ``mesh.devices[i]``."""
    return LaneSharding(fleet_mesh(mesh))


class LaneChunks:
    """A lane-axis record cut into a ``LaneSharding``'s chunks: ``parts[i]``
    is the record of chunk ``i``'s lanes, on ``devices[i]``.  ``n_lanes``
    (at most the chunks' total) is how many leading lanes are real; the
    rest are mesh padding, kept in the chunks but never gathered."""

    __slots__ = ("sharding", "parts", "n_padded", "n_lanes")

    def __init__(self, sharding: LaneSharding, parts: list,
                 n_lanes: "int | None" = None,
                 n_padded: "int | None" = None):
        self.sharding = sharding
        self.parts = list(parts)
        # the chunks' lane total (given by callers that know it: the
        # fleet tick builds these every poll)
        self.n_padded = (sum(_rec_first(p).shape[0] for p in self.parts)
                         if n_padded is None else int(n_padded))
        self.n_lanes = self.n_padded if n_lanes is None else int(n_lanes)

    def head(self, n: int) -> "LaneChunks":
        """The same chunks with only the first ``n`` lanes real."""
        if n > self.n_padded:
            raise ValueError(f"{n} lanes of {self.n_padded}")
        return LaneChunks(self.sharding, self.parts, n, self.n_padded)

    def lane(self, i: int) -> Any:
        """Lane ``i``'s record (0-d leaves, on its chunk's device)."""
        c, j = self.sharding.owner(i, self.n_padded)
        return rec_map(lambda x: x[j], self.parts[c])

    def with_lane(self, i: int, fn: Callable) -> "LaneChunks":
        """These chunks with the owner of lane ``i`` replaced by
        ``fn(part, offset)``; no other chunk is touched."""
        c, j = self.sharding.owner(i, self.n_padded)
        parts = list(self.parts)
        parts[c] = fn(parts[c], j)
        return LaneChunks(self.sharding, parts, self.n_lanes, self.n_padded)

    def gather(self, device: "torch.device | str") -> Any:
        """The real lanes as one record on ``device`` (one chunk already
        there is returned as it is)."""
        dev = torch.device(device)
        if len(self.parts) == 1:
            whole = self.parts[0]
            if self.sharding.mesh.devices[0] != dev:
                whole = rec_map(lambda x: x.to(dev), whole)
        else:
            whole = rec_map(lambda *xs: torch.cat([x.to(dev) for x in xs]),
                             *self.parts)
        if self.n_lanes == self.n_padded:
            return whole
        return rec_map(lambda x: x[:self.n_lanes], whole)


def shard_fleet_tick(fn: Callable, mesh: FleetMesh) -> Callable:
    """Partition a per-lane fleet tick over the ``cams`` axis.

    The returned tick takes the 8 operands of ``fused_fleet_tick``, each a
    whole record (its lane count a multiple of the device count:
    ``padded_lane_count``) or a ``LaneChunks`` of this mesh's sharding,
    runs ``fn`` on each chunk on that chunk's device, and returns each of
    ``fn``'s outputs as a ``LaneChunks``.  Lanes are fully independent --
    no collectives -- so the split cannot change a value.
    """
    sharding = fleet_sharding(mesh)

    def tick(*operands):
        if len(operands) != 8:
            raise TypeError(f"the fleet tick takes 8 operands, got "
                            f"{len(operands)}")
        chunked = []
        for op in operands:
            if isinstance(op, LaneChunks):
                if op.sharding is not sharding and op.sharding != sharding:
                    raise ValueError("operand chunked over another mesh")
                chunked.append(op)
            else:
                chunked.append(sharding.split(op))
        lanes = {c.n_padded for c in chunked}
        if len(lanes) != 1:
            raise ValueError(f"operands of different lane counts {lanes}")
        n = lanes.pop()
        outs = [fn(*(c.parts[i] for c in chunked))
                for i in range(mesh.size)]
        return tuple(LaneChunks(sharding, [o[j] for o in outs], n_padded=n)
                     for j in range(len(outs[0])))

    return tick
