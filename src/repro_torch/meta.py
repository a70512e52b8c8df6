"""Accounting a step on the meta device, the dry-run's counterpart of a
lowering.

Tensors on ``torch.device("meta")`` have shapes, strides and dtypes but no
storage: an operation on them allocates nothing and computes nothing.
``MetaPass`` watches a step run on them and counts the bytes the step's
own tensors hold, the FLOPs of its matrix products, the bytes its
operations read and write and their transcendental functions, and the
collectives a rank's partitioned step issues, by JAX's kinds
(``launch/dryrun.py`` reads them all).

PyTorch's meta functions are mostly Python, and a model's loops repeat the
same few shapes thousands of times, so a pass over a 32k-token cell would
take minutes.  Two things make it cheap without changing what it counts:

  * ``MetaPass`` runs an operation that returns new tensors once for each
    distinct signature, and hands a repeat empty tensors of the shapes it
    recorded;
  * a loop whose iterations repeat one another's shapes runs only some of
    them on meta tensors (``loop_repeats``): the skipped ones are counted
    by running a representative under ``repeated(n)``, which multiplies
    the FLOPs ``MetaPass`` counts, and a loop that keeps each iteration's
    output keeps an empty tensor of its shape for each skipped one, so the
    live bytes stay exact.  On any other device, and where autograd
    records the loop (its saved tensors would go uncounted), every
    iteration runs.  Four loops take it: the chunked attention's,
    ``wkv_plain``'s, the SSD's and the train step's microbatches; run
    whole, their passes took minutes (zamba2's 32k prefill 69 s where it
    takes 2 s, its train step more than 5 minutes).  Reckoning a deep
    cell from short passes instead does not hold: the peak is the largest
    of lines in the depth that cross (moonshot's train step at batch 8
    and 7 layers: 77.1 GB carried from 2 and 3 layers, 80.3 GB in a whole
    pass).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.sharding.collectives import KINDS, OP_KINDS

__all__ = ["MetaPass", "tensors_of", "distinct_bytes", "repeated",
           "loop_repeats", "checkpoint_repeated", "META", "TRANSCENDENTAL"]

META = torch.device("meta")


def _packets(*names: str) -> frozenset:
    """The aten overload packets of ``names`` and of their in-place forms
    (``exp`` and ``exp_``), those this PyTorch has."""
    aten = torch.ops.aten
    return frozenset(p for n in names for p in (getattr(aten, n, None),
                                                 getattr(aten, n + "_", None))
                     if p is not None)


# the operations whose output elements ``MetaPass`` counts as
# transcendentals: exp, expm1, log, log1p, tanh, sigmoid, silu, softplus,
# gelu (tanh or erf), erf, sin, cos, rsqrt, sqrt, softmax and log_softmax,
# and the backward ops of those that have one
TRANSCENDENTAL = _packets(
    "exp", "expm1", "log", "log1p", "tanh", "sigmoid", "silu", "softplus",
    "gelu", "erf", "sin", "cos", "rsqrt", "sqrt", "_softmax",
    "_log_softmax", "tanh_backward", "sigmoid_backward", "silu_backward",
    "softplus_backward", "gelu_backward", "_softmax_backward_data",
    "_log_softmax_backward_data")
# allocations without values: they read and write nothing
_ALLOCATIONS = _packets("empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided")

_REPEAT = contextvars.ContextVar("repro_torch_meta_repeat", default=1)


@contextlib.contextmanager
def repeated(n: int):
    """The operations run inside stand for ``n`` runs of themselves: a
    ``MetaPass`` counts their FLOPs, bytes accessed and transcendentals
    ``n`` times."""
    token = _REPEAT.set(_REPEAT.get() * n)
    try:
        yield
    finally:
        _REPEAT.reset(token)


def loop_repeats(n: int, t: torch.Tensor, *, alike: bool = False,
                 checkpointed: bool = False) -> list[int]:
    """How many times each of a loop's ``n`` iterations counts: ``[1] *
    n`` (every one runs) unless ``t`` lies on the meta device and autograd
    does not record the loop, or records it with each iteration under
    activation checkpointing (``checkpointed``; the caller then runs the
    representative through ``checkpoint_repeated``).  Then, where
    iterations 1 .. n-2 repeat one another's shapes, ``[1, 0, ..., 0, n -
    2, 1]``: the first and the last run once, iteration n-2 runs standing
    for n-2 of them (under ``repeated``), the others (0) are skipped; with
    ``alike`` (every iteration alike and nothing kept from one to the
    next) ``[n, 0, ..., 0]``."""
    recorded = torch.is_grad_enabled() and t.requires_grad
    if t.device.type != "meta" or (recorded and not checkpointed) or n <= 1:
        return [1] * n
    if alike:
        return [n] + [0] * (n - 1)
    if n <= 3:
        return [1] * n
    return [1] + [0] * (n - 3) + [n - 2, 1]


def tensors_of(obj) -> list[torch.Tensor]:
    """Every tensor in nested dicts, lists, tuples and dataclasses."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in tensors_of(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in tensors_of(v)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj)
                for t in tensors_of(getattr(obj, f.name))]
    return []


def distinct_bytes(obj) -> int:
    """Bytes of the distinct storages under ``obj`` (views counted once)."""
    seen = {}
    for t in tensors_of(obj):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class _Repeated(torch.autograd.Function):
    """A checkpointed call standing for ``n`` calls: the forward runs
    without saving activations and counts ``n`` times; the backward
    recomputes it and differentiates it, counted ``n`` times.  It also
    saves ``hold``, the inputs the stood-for calls would have saved, until
    its backward."""

    @staticmethod
    def forward(ctx, n, fn, n_args, *tensors):
        args, hold = tensors[:n_args], tensors[n_args:]
        ctx.n, ctx.fn, ctx.n_args, ctx.n_hold = n, fn, n_args, len(hold)
        ctx.save_for_backward(*args, *hold)
        with repeated(n):
            return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[3:3 + ctx.n_args]
        args = [a.detach().requires_grad_(r) for a, r in
                zip(saved[:ctx.n_args], need)]
        del saved
        with torch.enable_grad(), repeated(ctx.n):
            outs = ctx.fn(*args)
            wrt = [a for a in args if a.requires_grad]
            got = iter(torch.autograd.grad(outs, wrt, grads,
                                           allow_unused=True))
        return (None, None, None,
                *[next(got) if a.requires_grad else None for a in args],
                *[None] * ctx.n_hold)


def checkpoint_repeated(n: int, fn, args: tuple, hold: list):
    """``fn(*args)`` under activation checkpointing, standing for ``n``
    such calls on the meta device: FLOPs counted ``n`` times forward and
    backward, and ``hold`` (an empty tensor for each input the skipped
    calls would have saved) kept alive until the backward reaches it, so
    the live bytes match the loop that runs every call.  The backward
    recomputes the whole call, where ``torch.utils.checkpoint`` stops its
    recomputation after the last saved tensor: the FLOPs can exceed the
    full loop's by the operations after it (0.1% in zamba2's train
    cell)."""
    return _Repeated.apply(n, fn, len(args), *args, *hold)


class MetaPass(TorchDispatchMode):
    """Watches a step run on meta tensors: the bytes of the storages the
    step creates that are still alive after each operation, their peak
    (``peak``), and the FLOPs of its matrix products (``flops``, by
    ``torch.utils.flop_counter``'s registry, the formulas
    ``FlopCounterMode`` counts by).  The storages of ``exclude`` (a step's
    arguments) and their views count nothing, so a step's in-place writes
    into its inputs count nothing either.  ``live()`` is the bytes still
    held, freed storages dropped.

    Beside the FLOPs, XLA's other two cost figures, counted per eager
    operation: ``bytes_accessed``, the bytes of every tensor an operation
    reads plus every tensor it writes (an in-place write counts its read
    and its write; a view, whose outputs share an input's storage, and an
    allocation without values, ``empty`` and its kin, count nothing), and
    ``transcendentals``, the output elements of the
    operations of ``TRANSCENDENTAL``.  Each operation's three counts are
    computed once a signature (the memo's key) and kept in the memo.

    It also makes the pass cheap without changing what it computes: an
    operation that returns new tensors (no view, no in-place write) is run
    once for each distinct signature (operation, argument shapes, strides,
    dtypes and values); a repeat gets empty meta tensors of the recorded
    shapes and strides.  A model's layers and chunk loops repeat the same
    few signatures, and PyTorch's meta functions are Python: this takes a
    32k prefill's pass from ~10 s to ~4 s.  ``memo`` may be shared between
    passes.  Operations run under ``repeated(n)`` count their FLOPs, bytes
    and transcendentals ``n`` times.

    The collectives (the ``_c10d_functional`` ops a rank's step issues
    through ``sharding/collectives.py``, on meta tensors over a fake
    process group) are counted by JAX's kinds as its
    ``parse_collectives`` records them: ``collectives[kind]`` holds the
    count and the bytes of the outputs, each multiplied by the
    ``repeated(n)`` around it (a loop's representative iteration).  They
    are always run, never taken from the memo, and counted here rather
    than by a ``CommDebugMode`` outside the pass, which would miss the
    iterations ``repeated`` stands for; a ``remat`` block's recomputation
    in the backward pass re-issues its collectives, and they count
    too."""

    def __init__(self, exclude=(), memo: "dict | None" = None):
        super().__init__()
        self.memo = {} if memo is None else memo
        self._kinds = {}    # operation -> "new", "view" or "write"
        self._args = {}     # storage key -> weak ref (arguments)
        self._live = {}     # storage key -> (weak ref, bytes)
        for t in tensors_of(exclude):
            st = t.untyped_storage()
            self._args[st._cdata] = StorageWeakRef(st)
        self.now = 0
        self.peak = 0
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.collectives = {k: {"bytes": 0, "count": 0} for k in KINDS}

    @staticmethod
    def _key(a):
        if isinstance(a, torch.Tensor):
            return (tuple(a.shape), a.stride(), a.dtype, a.device.type)
        if isinstance(a, (list, tuple)):
            return tuple(MetaPass._key(x) for x in a)
        return a

    def _kind(self, func) -> str:
        """``"new"`` where ``func`` returns new tensors, ``"view"`` where
        it returns views of its inputs, ``"write"`` where it writes in
        place (the schema's word; a run still checks the storages)."""
        kind = self._kinds.get(func)
        if kind is None:
            schema = func._schema
            aliased = any(r.alias_info is not None for r in schema.returns)
            kind = ("write" if schema.is_mutable else
                    "view" if aliased else "new")
            self._kinds[func] = kind
        return kind

    @staticmethod
    def _cost(func, args, kwargs, out) -> tuple[int, int, int]:
        """(FLOPs, bytes read and written, transcendentals) of one call."""
        outs = [t for t in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(t, torch.Tensor)]
        ins = tensors_of(args) + tensors_of(kwargs)
        inputs = {t.untyped_storage()._cdata for t in ins}
        if func._overloadpacket in _ALLOCATIONS or (
                not func._schema.is_mutable and all(
                    t.untyped_storage()._cdata in inputs for t in outs)):
            moved = 0               # an allocation, or an undeclared view
        else:
            moved = sum(t.numel() * t.element_size() for t in ins + outs)
        count = flop_registry.get(func._overloadpacket)
        flops = count(*args, **kwargs, out_val=out) if count else 0
        trans = (sum(t.numel() for t in outs)
                 if func._overloadpacket in TRANSCENDENTAL else 0)
        return flops, moved, trans

    def _run(self, func, args, kwargs, kind: str) -> tuple:
        """(the outputs, whether they are new empty tensors from the
        memo, the call's ``_cost``).  The memo keeps, a signature (the
        operation and its arguments' shapes, strides, dtypes and values),
        the outputs' specs (``False`` where the operation is not run once a
        signature: an in-place write, outputs that alias an input or lie
        off the meta device) and the cost."""
        key = (func, self._key(args),
               tuple(sorted((k, self._key(v)) for k, v in kwargs.items())))
        try:
            entry = self.memo.get(key)
        except TypeError:           # an argument that does not hash
            key = entry = None
        if entry is None:
            out = func(*args, **kwargs)
            spec = False
            if kind == "new":
                outs = out if isinstance(out, (tuple, list)) else (out,)
                ins = {t.untyped_storage()._cdata for t in tensors_of(args)}
                if all(isinstance(t, torch.Tensor)
                       and t.device.type == "meta"
                       and t.untyped_storage()._cdata not in ins
                       for t in outs):
                    spec = (isinstance(out, (tuple, list)),
                            [(t.shape, t.stride(), t.dtype) for t in outs])
            cost = self._cost(func, args, kwargs, out)
            if key is not None:
                self.memo[key] = (spec, cost)
            return out, False, cost
        spec, cost = entry
        if spec is False:
            return func(*args, **kwargs), False, cost
        many, specs = spec
        outs = [torch.empty_strided(shape, stride, dtype=dtype, device=META)
                for shape, stride, dtype in specs]
        return (tuple(outs) if many else outs[0]), True, cost

    def _known(self, key) -> bool:
        ref = self._args.get(key)
        if ref is not None and not ref.expired():
            return True
        entry = self._live.get(key)
        if entry is None:
            return False
        if entry[0].expired():      # a freed storage whose key came back
            del self._live[key]
            self.now -= entry[1]
            return False
        return True

    def live(self) -> int:
        """The bytes of the step's storages still alive, freed ones
        dropped."""
        for key, (ref, n) in list(self._live.items()):
            if ref.expired():
                del self._live[key]
                self.now -= n
        return self.now

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "_c10d_functional":
            out, fresh = func(*args, **kwargs), False
            coll = OP_KINDS.get(func._schema.name.split("::")[-1])
            if coll is not None:        # not a wait
                n = _REPEAT.get()
                self.collectives[coll]["count"] += n
                self.collectives[coll]["bytes"] += n * sum(
                    t.numel() * t.element_size() for t in tensors_of(out))
        elif self._kind(func) == "view":
            out, fresh = func(*args, **kwargs), False
        else:
            out, fresh, cost = self._run(func, args, kwargs,
                                         self._kind(func))
            n = _REPEAT.get()
            self.flops += n * cost[0]
            self.bytes_accessed += n * cost[1]
            self.transcendentals += n * cost[2]
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st._cdata
                if fresh:           # a new storage, though its key may
                    old = self._live.pop(key, None)     # have come back
                    if old is not None:
                        self.now -= old[1]
                elif self._known(key):
                    continue
                self._live[key] = (StorageWeakRef(st), st.nbytes())
                self.now += st.nbytes()
        # freed storages are dropped only when the count would pass the
        # peak: until then it overstates the live bytes, and the peak,
        # which it does not reach, stands
        if self.now > self.peak:
            self.peak = max(self.peak, self.live())
        return out
