"""Runtime layout guard for the port's control planes.

The JAX package's guard fails a test on an unexpected jit recompile.  The
port compiles nothing; what a recompile stood for there -- the fused tick
running on another table layout (lanes x capacity) -- is what each guarded
target counts here, under the same ``cache_size()`` name:

    with trace_guard(fleet, monitor):
        for latencies in timeline:
            fleet.decide(latencies)
    # exiting asserts: each target ran on at most one layout inside the
    # block (a warm target may not move to another at all)

Targets are anything with a ``cache_size()`` method (``FleetController``,
``DriftMonitor``, ``CollectiveController``).
``expect`` raises the per-target allowance when a block legitimately runs
N layouts.

``assert_compiled_once`` is the post-hoc form for counts *recorded* by the
scenario harness (``ScenarioResult.fleet_cache_size``), where the live
object is gone by the time the test can look.
"""

from __future__ import annotations

import contextlib


class TraceGuardError(AssertionError):
    """A guarded target moved to an unexpected table layout."""


def _size(target) -> int:
    fn = getattr(target, "cache_size", None)
    if not callable(fn):
        raise TypeError(
            f"trace_guard target {target!r} exposes no cache_size()")
    return int(fn())


def _label(target, i: int) -> str:
    name = getattr(target, "__name__", None) or type(target).__name__
    return f"{name}#{i}"


@contextlib.contextmanager
def trace_guard(*targets, expect: int = 1):
    """Fail if any target's layout count grows past ``max(initial,
    expect)``.

    A cold target is allowed its first ``expect`` layouts (the warm-up); a
    warm target is allowed none.  Raises ``TraceGuardError`` naming every
    offender with before/after counts.
    """
    if not targets:
        raise TypeError("trace_guard needs at least one target")
    before = [_size(t) for t in targets]
    yield
    offenders = []
    for i, (t, b) in enumerate(zip(targets, before)):
        after = _size(t)
        allowed = max(b, expect)
        if after > allowed:
            offenders.append(
                f"{_label(t, i)}: cache {b} -> {after} (allowed {allowed})")
    if offenders:
        raise TraceGuardError(
            "unexpected layout change(s) inside trace_guard block:\n  "
            + "\n  ".join(offenders))


def assert_compiled_once(recorded, label: str = "recorded cache size") -> None:
    """Check a layout count *recorded* by a harness (an int, not a live
    object): exactly one layout means every swap and retarget of the hot
    loop kept the tick's shapes end to end."""
    if recorded != 1:
        raise TraceGuardError(
            f"{label}: expected exactly 1 table layout, got {recorded!r}"
            " -- the tick changed shape (or never ran) in the hot loop")
