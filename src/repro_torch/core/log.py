"""Mez in-memory log (paper Section 4.3).

Append-only, time-ordered circular buffer of <timestamp, frame> pairs with:

  * single-writer / multi-reader semantics,
  * segment-granular read-write locking (reads from many segments proceed
    concurrently; exactly one segment is active for writes),
  * O(log n) point queries (binary search over timestamps) and range queries
    (two binary searches),
  * rejection of out-of-order appends (timestamp <= last entry),
  * wrap-around overwrite of the oldest entries when capacity is exceeded,
  * background persistence with per-segment CRC32 purely for crash recovery
    (never on the read/write critical path), paper Section 4.4.

``HostLog`` is the host-side log (NumPy payloads, threading locks): the
broker layer.  ``FrameLog`` and the ``frame_log_*`` functions are the
device ring of the camera node: a fixed-capacity ring of frames in device
memory, appended and queried without a device-to-host read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import zlib
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["HostLog", "LogSegmentStore", "FrameLog", "frame_log_init",
           "frame_log_append", "frame_log_point_query",
           "frame_log_range_query"]


# =============================================================================
# Host-side log (broker substrate)
# =============================================================================


class _RWLock:
    """Writer-preferring read-write lock (no stdlib equivalent)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0           # guarded-by: _cond
        self._writer = False        # guarded-by: _cond
        self._writers_waiting = 0   # guarded-by: _cond

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


@dataclasses.dataclass
class _Entry:
    timestamp: float
    frame: np.ndarray
    meta: dict


class HostLog:
    """The paper's in-memory log, host side.

    Capacity is given in *entries*; the paper sizes it in bytes (1 GB ~ 7 min
    at 500 kB / 5 fps) -- callers convert.  Segmentation: the ring is divided
    into ``num_segments`` contiguous segments, each with its own RW lock.
    The writer only ever holds the lock of the segment it appends into, so
    readers of other segments never block (paper: "reads can occur from many
    segments concurrently, while only one segment is active for write").
    """

    def __init__(self, capacity: int, *, num_segments: int = 8, topic: str = ""):
        if capacity < num_segments:
            num_segments = max(1, capacity)
        self.capacity = int(capacity)
        self.num_segments = int(num_segments)
        self.topic = topic
        self._entries: list[_Entry | None] = [None] * self.capacity  # guarded-by: _seg_locks
        self._head = 0          # next write position; guarded-by: _meta_lock
        self._count = 0         # number of live entries; guarded-by: _meta_lock
        self._last_ts = -np.inf  # guarded-by: _meta_lock
        self._seg_locks = [_RWLock() for _ in range(self.num_segments)]
        self._meta_lock = threading.Lock()
        self._evictions = 0     # wrap-around generation; guarded-by: _meta_lock
        self.appends = 0        # guarded-by: _meta_lock
        self.rejects = 0        # guarded-by: _meta_lock

    # -- geometry ---------------------------------------------------------------
    def _segment_of(self, idx: int) -> int:
        return (idx * self.num_segments) // self.capacity

    def __len__(self) -> int:
        with self._meta_lock:
            return self._count

    @property
    def last_timestamp(self) -> float:
        with self._meta_lock:
            return self._last_ts

    # -- write path -------------------------------------------------------------
    def append(self, timestamp: float, frame: np.ndarray, **meta) -> bool:
        """Append one frame.  Returns False (rejected) if out of order.

        Wrap-around ordering: the slot being overwritten is *evicted from
        the live set first* (count decremented under the meta lock), the
        entry is written under its segment write lock, and only then is the
        new entry published to the metadata.  Readers snapshotting under
        the meta lock therefore never see a slot that is mid-overwrite --
        the entry write happens outside every reader's ordered view.
        """
        with self._meta_lock:
            if timestamp <= self._last_ts:
                self.rejects += 1
                return False
            idx = self._head
            seg = self._segment_of(idx)
            if self._count == self.capacity:
                self._count -= 1           # evict the oldest (it lives at idx)
                self._evictions += 1
        lock = self._seg_locks[seg]
        lock.acquire_write()
        try:
            self._entries[idx] = _Entry(timestamp, frame, dict(meta))
        finally:
            lock.release_write()
        with self._meta_lock:
            self._head = (idx + 1) % self.capacity
            self._count = min(self._count + 1, self.capacity)
            self._last_ts = timestamp
            self.appends += 1
        return True

    # -- read path ---------------------------------------------------------------
    # holds-lock: _meta_lock
    def _ordered_indices(self) -> list[int]:
        """Indices of live entries in increasing timestamp order (the ring
        starts ``count`` slots behind the next write position)."""
        start = (self._head - self._count) % self.capacity
        return [(start + i) % self.capacity for i in range(self._count)]

    def _snapshot_view(self, order: Sequence[int]
                       ) -> list[tuple[float, np.ndarray]]:
        """(timestamp, frame) view of ``order``'s entries, read under all
        spanned segment read locks (acquired in ascending segment order;
        the writer holds at most one segment lock at a time and never waits
        on the meta lock while holding one, so the ordering is
        deadlock-free).  The segment locks make each entry read atomic with
        respect to the writer; whole-view consistency across a wrap-around
        is validated by ``_consistent_snapshot``.  Frames are immutable
        once appended, so the returned references remain valid after the
        locks drop."""
        segs = sorted({self._segment_of(i) for i in order})
        for s in segs:
            self._seg_locks[s].acquire_read()
        try:
            return [(e.timestamp, e.frame)
                    for e in (self._entries[i] for i in order)]
        finally:
            for s in segs:
                self._seg_locks[s].release_read()

    def _consistent_snapshot(self) -> list[tuple[float, np.ndarray]]:
        """Time-ordered snapshot of the live ring, seqlock style.

        Readers never hold the meta lock across the O(capacity) scan (reads
        from many segments keep proceeding concurrently, per the paper's
        locking design).  Instead the wrap-around generation counter is
        sampled before and after: a wrap eviction racing the scan would
        overwrite the oldest slot with the newest entry mid-read -- binary
        search would then run on an unsorted array (caught by the threaded
        regression test) -- so a changed generation discards the torn view
        and retries.  If the writer keeps lapping the reader, the final
        attempt scans inside the meta lock, which blocks eviction entirely.
        """
        for _ in range(4):
            with self._meta_lock:
                order = self._ordered_indices()
                gen = self._evictions
            snap = self._snapshot_view(order)
            with self._meta_lock:
                if self._evictions == gen:
                    return snap
        with self._meta_lock:
            return self._snapshot_view(self._ordered_indices())

    def _timestamps(self, snap: Sequence[tuple[float, np.ndarray]]
                    ) -> np.ndarray:
        return np.asarray([t for t, _ in snap])

    def point_query(self, timestamp: float) -> tuple[float, np.ndarray] | None:
        """Newest entry with ts <= timestamp (binary search), or None."""
        snap = self._consistent_snapshot()
        if not snap:
            return None
        ts = self._timestamps(snap)
        pos = int(np.searchsorted(ts, timestamp, side="right")) - 1
        if pos < 0:
            return None
        return snap[pos]

    def range_query(self, t_start: float, t_stop: float) -> Iterator[tuple[float, np.ndarray]]:
        """All entries with t_start <= ts <= t_stop, in time order.

        Paper: "Range queries are ... supported by querying the starting and
        ending timestamp, returning the video frames corresponding to an
        interval that includes the requested time range."
        """
        snap = self._consistent_snapshot()
        if not snap:
            return
        ts = self._timestamps(snap)
        lo = int(np.searchsorted(ts, t_start, side="left"))
        hi = int(np.searchsorted(ts, t_stop, side="right"))
        yield from snap[lo:hi]

    def tail(self, k: int) -> list[tuple[float, np.ndarray]]:
        return self._consistent_snapshot()[-k:]

    def snapshot(self) -> list[tuple[float, np.ndarray]]:
        return self.tail(len(self))


# =============================================================================
# Persistence with per-segment CRC (paper Section 4.4)
# =============================================================================


class LogSegmentStore:
    """Durable store for log segments with CRC32 integrity.

    Layout: ``<root>/<topic>/seg_<n>.npz`` + ``seg_<n>.crc`` (hex CRC of the
    npz bytes) + ``MANIFEST.json``.  Writes are atomic (tmp + rename).
    Partially-written / corrupted segments are detected by CRC mismatch and
    discarded on recovery, exactly as the paper prescribes.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _topic_dir(self, topic: str) -> str:
        d = os.path.join(self.root, topic)
        os.makedirs(d, exist_ok=True)
        return d

    def persist(self, log: HostLog, *, segment_entries: int = 64) -> int:
        """Persist the current snapshot as CRC'd segments; returns #segments."""
        snap = log.snapshot()
        d = self._topic_dir(log.topic or "default")
        manifest = {"topic": log.topic, "segments": [], "capacity": log.capacity,
                    "num_segments": log.num_segments}
        nseg = 0
        for s in range(0, len(snap), segment_entries):
            chunk = snap[s : s + segment_entries]
            ts = np.asarray([t for t, _ in chunk])
            frames = np.stack([f for _, f in chunk]) if chunk else np.zeros((0,))
            tmp = os.path.join(d, f".seg_{nseg}.npz.tmp")
            final = os.path.join(d, f"seg_{nseg}.npz")
            with open(tmp, "wb") as fh:
                np.savez(fh, timestamps=ts, frames=frames)
            with open(tmp, "rb") as fh:
                crc = zlib.crc32(fh.read()) & 0xFFFFFFFF
            os.replace(tmp, final)
            with open(os.path.join(d, f"seg_{nseg}.crc"), "w") as fh:
                fh.write(f"{crc:08x}")
            manifest["segments"].append({"file": f"seg_{nseg}.npz", "crc": f"{crc:08x}",
                                         "n": len(chunk)})
            nseg += 1
        tmp_m = os.path.join(d, ".MANIFEST.json.tmp")
        with open(tmp_m, "w") as fh:
            json.dump(manifest, fh)
        os.replace(tmp_m, os.path.join(d, "MANIFEST.json"))
        return nseg

    def recover(self, topic: str) -> HostLog | None:
        """Rebuild a HostLog from disk, discarding CRC-mismatched segments."""
        d = os.path.join(self.root, topic or "default")
        mpath = os.path.join(d, "MANIFEST.json")
        if not os.path.exists(mpath):
            return None
        with open(mpath) as fh:
            manifest = json.load(fh)
        log = HostLog(manifest["capacity"], num_segments=manifest["num_segments"],
                      topic=manifest["topic"])
        for seg in manifest["segments"]:
            path = os.path.join(d, seg["file"])
            if not os.path.exists(path):
                continue  # partially written: discard
            with open(path, "rb") as fh:
                raw = fh.read()
            if f"{zlib.crc32(raw) & 0xFFFFFFFF:08x}" != seg["crc"]:
                continue  # corrupted: discard (paper Section 4.4)
            with np.load(path) as data:
                ts, frames = data["timestamps"], data["frames"]
            for t, f in zip(ts, frames):
                log.append(float(t), np.asarray(f))
        return log

    def corrupt_segment(self, topic: str, seg_index: int) -> None:
        """Test helper: flip bytes in a segment to emulate a torn write."""
        path = os.path.join(self.root, topic or "default", f"seg_{seg_index}.npz")
        with open(path, "r+b") as fh:
            fh.seek(16)
            b = fh.read(1)
            fh.seek(16)
            fh.write(bytes([b[0] ^ 0xFF]))


# =============================================================================
# Device-side log: a ring of frames in device memory
# =============================================================================

# A FrameLog holds tensors on one device:
#   timestamps : f32[capacity]  (monotone in ring order; -inf = empty slot)
#   payload    : dtype[capacity, *frame_shape]
#   head       : i32[]          (next write slot)
#   count      : i32[]          (live entries, <= capacity)
#   last_ts    : f32[]
#   rejects    : i32[]          (out-of-order appends refused)
#
# Ring order: the oldest entry lives at (head - count) mod capacity.  Queries
# build the time-ordered view with a gather and searchsorted.  Every field
# stays on the device: an append or a query makes no device-to-host read.


@dataclasses.dataclass
class FrameLog:
    timestamps: torch.Tensor
    payload: torch.Tensor
    head: torch.Tensor
    count: torch.Tensor
    last_ts: torch.Tensor
    rejects: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.timestamps.shape[0]


def frame_log_init(capacity: int, frame_shape: tuple[int, ...],
                   dtype: torch.dtype = torch.uint8,
                   device: "str | torch.device | None" = None) -> FrameLog:
    """An empty ring of ``capacity`` frames of ``frame_shape`` and
    ``dtype`` on ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    return FrameLog(
        timestamps=torch.full((capacity,), -torch.inf, dtype=torch.float32,
                              device=dev),
        payload=torch.zeros((capacity, *frame_shape), dtype=dtype,
                            device=dev),
        head=torch.zeros((), dtype=torch.int32, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        last_ts=torch.full((), -torch.inf, dtype=torch.float32, device=dev),
        rejects=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _timestamp(log: FrameLog, timestamp) -> torch.Tensor:
    """``timestamp`` as a float32 scalar on the log's device, rounded to
    float32 before any comparison (0.1 in float64 is not 0.1 in float32)."""
    if isinstance(timestamp, torch.Tensor):
        return timestamp.to(device=log.timestamps.device,
                            dtype=torch.float32).reshape(())
    return torch.full((), float(timestamp), dtype=torch.float32,
                      device=log.timestamps.device)


def frame_log_append(log: FrameLog, timestamp, frame) -> FrameLog:
    """Append ``frame`` at ``timestamp``; an append whose timestamp is not
    above the newest one is refused and only counted (``rejects``).

    The log is updated in place and returned, as the JAX caller donates
    it: the one slot is written whether or not the append is taken (the
    frame or the slot's own contents, chosen on the device), so an append
    copies one frame, never the ring, and makes no host sync.  ``frame``
    may be a tensor or an array on the host; it is cast to the payload's
    dtype."""
    dev = log.payload.device
    ts = _timestamp(log, timestamp)
    frame = torch.as_tensor(frame).to(device=dev, dtype=log.payload.dtype)
    ok = ts > log.last_ts
    idx = log.head.reshape(1).long()
    slot = log.payload.index_select(0, idx)
    log.payload.index_copy_(
        0, idx, torch.where(ok, frame.reshape(slot.shape), slot))
    log.timestamps.index_copy_(
        0, idx, torch.where(ok, ts, log.timestamps.index_select(0, idx)))
    log.count.copy_(torch.where(
        ok, torch.clamp(log.count + 1, max=log.capacity), log.count))
    log.head.copy_(torch.where(ok, (log.head + 1) % log.capacity, log.head))
    log.last_ts.copy_(torch.where(ok, ts, log.last_ts))
    log.rejects.add_((~ok).to(torch.int32))
    return log


def _ordered_view(log: FrameLog) -> tuple[torch.Tensor, torch.Tensor]:
    """Timestamps in time order + the gather indices producing that order."""
    cap = log.capacity
    ar = torch.arange(cap, device=log.timestamps.device)
    start = (log.head - log.count) % cap
    idx = (start + ar) % cap                   # oldest .. newest, then empties
    ts = log.timestamps[idx]
    # Mark empty slots (+inf) so searchsorted never lands past live entries.
    return torch.where(ar < log.count, ts, torch.inf), idx


def frame_log_point_query(log: FrameLog, timestamp
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Newest entry with ts <= timestamp.

    Returns (found, ts, frame); if not found, ts = -inf and frame is the
    payload of the oldest slot in ring order (callers must gate on
    ``found``).  A binary search over the time-ordered timestamps."""
    ts, idx = _ordered_view(log)
    pos = torch.searchsorted(ts, _timestamp(log, timestamp).reshape(1),
                             right=True) - 1
    found = pos >= 0
    safe = torch.clamp(pos, 0, log.capacity - 1)
    return (found[0], torch.where(found, ts[safe], -torch.inf)[0],
            log.payload[idx[safe]][0])


def frame_log_range_query(log: FrameLog, t_start, t_stop, max_results: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Entries with t_start <= ts <= t_stop, oldest first, fixed-size output.

    Returns (valid_mask[max_results], ts[max_results] with -inf where not
    valid, frames[max_results, ...] gathered at clipped positions).
    ``max_results`` plays the role of the subscriber's fetch window."""
    ts, idx = _ordered_view(log)
    lo = torch.searchsorted(ts, _timestamp(log, t_start).reshape(1))
    hi = torch.searchsorted(ts, _timestamp(log, t_stop).reshape(1),
                            right=True)
    offs = lo + torch.arange(max_results, device=ts.device)
    valid = offs < hi
    safe = torch.clamp(offs, 0, log.capacity - 1)
    return (valid, torch.where(valid, ts[safe], -torch.inf),
            log.payload[idx[safe]])
