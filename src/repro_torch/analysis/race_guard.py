"""Runtime lock instrumentation of the port's host locks.

``race_guard`` wraps the locks of ``repro_torch.core.log.HostLog``
(segment ``_RWLock``s + ``_meta_lock``) and
``repro_torch.core.broker.CamBroker`` (``_version_lock``) in bookkeeping
proxies while the context is active:

  * **Exclusion invariants**: a writer entering while readers (or another
    writer) are inside the same RW lock, or two threads inside one mutex,
    is recorded as a violation (the static lock rule, mezlint MZ03, sees
    unlocked access; this guard covers the lock implementation itself and
    future refactors of it).
  * **Lock-order cycles**: acquiring B while holding A adds an A->B edge;
    a cycle in that graph is a latent deadlock even if the soak run never
    actually deadlocked.

Instances created *inside* the context are instrumented automatically
(``HostLog.__init__`` / ``CamBroker.__init__`` are patched for the
duration); pre-existing objects can be passed to ``instrument()``.

Violations raise ``RaceGuardError`` on exit (collected, not thrown
mid-flight, so the offending interleaving is reported in full).

``from_env()`` gives one guard where ``MEZLINT_RACE_GUARD=1`` (a soak
job's switch), else ``None``: a caller enters it around a test or a run
when it is given one.
"""

from __future__ import annotations

import os
import threading


class RaceGuardError(AssertionError):
    """Lock-discipline violation observed at runtime."""


class _Shared:
    """Bookkeeping shared by every proxy of one race_guard context."""

    def __init__(self) -> None:
        self.mu = threading.Lock()
        self.violations: list[str] = []
        self.held = threading.local()       # per-thread list of labels
        self.order: dict[str, set[str]] = {}  # label -> labels acquired after

    def stack(self) -> list[str]:
        if not hasattr(self.held, "v"):
            self.held.v = []
        return self.held.v

    def note_acquire(self, label: str) -> None:
        stack = self.stack()
        with self.mu:
            for outer in stack:
                if outer == label:
                    continue
                self.order.setdefault(outer, set()).add(label)
                if self._reaches(label, outer):
                    self.violations.append(
                        f"lock-order cycle: {outer} -> {label} while a "
                        f"{label} -> ... -> {outer} path exists")
        stack.append(label)

    def note_release(self, label: str) -> None:
        stack = self.stack()
        if label in stack:
            stack.remove(label)

    def _reaches(self, src: str, dst: str) -> bool:
        seen, frontier = set(), [src]
        while frontier:
            n = frontier.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            frontier.extend(self.order.get(n, ()))
        return False

    def violation(self, msg: str) -> None:
        with self.mu:
            self.violations.append(msg)


class _LockProxy:
    """Mutex wrapper: context manager + acquire/release, counted."""

    def __init__(self, inner, shared: _Shared, label: str):
        self._inner = inner
        self._shared = shared
        self._label = label
        self._owners = 0
        self._mu = threading.Lock()

    def acquire(self, *a, **kw):
        got = self._inner.acquire(*a, **kw)
        if got:
            with self._mu:
                self._owners += 1
                if self._owners > 1:
                    self._shared.violation(
                        f"{self._label}: {self._owners} threads inside a "
                        f"mutex at once")
            self._shared.note_acquire(self._label)
        return got

    def release(self):
        with self._mu:
            self._owners -= 1
        self._shared.note_release(self._label)
        return self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class _RWLockProxy:
    """``_RWLock`` wrapper checking reader/writer exclusion."""

    def __init__(self, inner, shared: _Shared, label: str):
        self._inner = inner
        self._shared = shared
        self._label = label
        self._mu = threading.Lock()
        self._readers = 0
        self._writers = 0

    def acquire_read(self):
        self._inner.acquire_read()
        with self._mu:
            self._readers += 1
            if self._writers:
                self._shared.violation(
                    f"{self._label}: reader admitted while a writer is "
                    f"inside")
        self._shared.note_acquire(self._label)

    def release_read(self):
        with self._mu:
            self._readers -= 1
        self._shared.note_release(self._label)
        self._inner.release_read()

    def acquire_write(self):
        self._inner.acquire_write()
        with self._mu:
            self._writers += 1
            if self._writers > 1 or self._readers:
                self._shared.violation(
                    f"{self._label}: writer admitted with {self._readers} "
                    f"readers / {self._writers} writers inside")
        self._shared.note_acquire(self._label)

    def release_write(self):
        with self._mu:
            self._writers -= 1
        self._shared.note_release(self._label)
        self._inner.release_write()


class race_guard:
    """Context manager; see module docstring.

    ``strict=True`` (default) raises ``RaceGuardError`` on exit when any
    violation was recorded; ``strict=False`` only collects them in
    ``.violations`` (useful when a test wants to assert on the content).
    """

    def __init__(self, *, strict: bool = True):
        self.strict = strict
        self.shared = _Shared()
        self._patches: list[tuple[type, str, object]] = []

    # -- public --------------------------------------------------------------
    @property
    def violations(self) -> list[str]:
        return list(self.shared.violations)

    def instrument(self, obj) -> None:
        """Wrap the known lock attributes of ``obj`` in proxies."""
        name = type(obj).__name__
        if hasattr(obj, "_meta_lock") and not isinstance(
                obj._meta_lock, _LockProxy):
            obj._meta_lock = _LockProxy(
                obj._meta_lock, self.shared, f"{name}._meta_lock")
        if hasattr(obj, "_seg_locks"):
            obj._seg_locks = [
                lk if isinstance(lk, _RWLockProxy) else _RWLockProxy(
                    lk, self.shared, f"{name}._seg_locks[{i}]")
                for i, lk in enumerate(obj._seg_locks)]
        if hasattr(obj, "_version_lock") and not isinstance(
                obj._version_lock, _LockProxy):
            obj._version_lock = _LockProxy(
                obj._version_lock, self.shared, f"{name}._version_lock")

    # -- context -------------------------------------------------------------
    def __enter__(self) -> "race_guard":
        from repro_torch.core.broker import CamBroker
        from repro_torch.core.log import HostLog
        self._patch_init(HostLog)
        self._patch_init(CamBroker)
        return self

    def _patch_init(self, cls: type) -> None:
        orig = cls.__init__
        guard = self

        def wrapped(self_obj, *a, **kw):
            orig(self_obj, *a, **kw)
            guard.instrument(self_obj)

        wrapped.__wrapped__ = orig
        cls.__init__ = wrapped
        self._patches.append((cls, "__init__", orig))

    def __exit__(self, exc_type, exc, tb) -> None:
        for cls, attr, orig in reversed(self._patches):
            setattr(cls, attr, orig)
        self._patches.clear()
        if exc_type is None and self.strict and self.shared.violations:
            raise RaceGuardError(
                "race_guard recorded violation(s):\n  "
                + "\n  ".join(self.shared.violations))


def from_env() -> "race_guard | None":
    """One guard when ``MEZLINT_RACE_GUARD=1`` (a soak job's switch), else
    ``None``."""
    if os.environ.get("MEZLINT_RACE_GUARD") == "1":
        return race_guard()
    return None
