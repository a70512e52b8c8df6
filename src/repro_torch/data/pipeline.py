"""Host-side data pipeline: token streams, prefetch, straggler hedging and
camera batches.

The port of the JAX package's ``data/pipeline.py``, copied as it is (NumPy
and threads only):
``TokenStream`` generates deterministic synthetic LM batches (zipfian
token ids with repeated phrases a model can learn), the same batches as
the JAX package's for the same seed; ``Prefetcher`` keeps a bounded queue
of ready batches filled by a producer thread, so the training loop never
waits on the host; ``BackupFetcher`` applies the tail-at-scale mitigation
-- a fetch that exceeds a deadline derived from the observed p95 fetch
time gets a backup fetch, and whichever finishes first wins;
``CameraBatcher`` turns delivered Mez frames (``DeliveredFrame``s or whole
``FrameBatch``es) into fixed-size model batches for the vision path.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np

__all__ = ["TokenStream", "Prefetcher", "BackupFetcher", "CameraBatcher"]


class TokenStream:
    """Deterministic synthetic LM batches: zipfian unigrams + a repeated-
    ngram structure so a real model can actually reduce loss on it."""

    def __init__(self, vocab_size: int, batch: int, seq: int, *,
                 seed: int = 0, ngram: int = 8):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.ngram = ngram
        self._rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        # a small bank of "phrases" the stream repeats (learnable structure)
        self._phrases = self._rng.integers(
            0, vocab_size, size=(64, ngram)).astype(np.int32)

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> dict:
        toks = self._rng.choice(self.vocab, size=(self.batch, self.seq + 1),
                                p=self._probs).astype(np.int32)
        # overwrite random windows with phrases (predictable continuations)
        n_spans = (self.seq // self.ngram) // 2
        for b in range(self.batch):
            starts = self._rng.integers(0, self.seq - self.ngram,
                                        size=n_spans)
            ids = self._rng.integers(0, len(self._phrases), size=n_spans)
            for s, i in zip(starts, ids):
                toks[b, s : s + self.ngram] = self._phrases[i]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Bounded-depth background prefetch of an iterator."""

    _SENTINEL = object()

    def __init__(self, it: Iterator, *, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None

        def run():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class BackupFetcher:
    """Tail-at-scale straggler mitigation for fetch functions.

    Tracks fetch latencies; when a fetch exceeds ``hedge_factor x p95``, a
    backup fetch is launched and the first result wins.  ``fetch_fn(i)`` must
    be idempotent (same i -> same batch), so duplicates are harmless --
    at-most-once delivery to the consumer is enforced here.
    """

    def __init__(self, fetch_fn: Callable[[int], object], *,
                 hedge_factor: float = 3.0, min_history: int = 8):
        self.fetch_fn = fetch_fn
        self.hedge_factor = hedge_factor
        self.min_history = min_history
        self._lat: list[float] = []
        self.hedges_issued = 0
        self.hedges_won = 0

    def _deadline(self) -> float | None:
        if len(self._lat) < self.min_history:
            return None
        return float(np.percentile(self._lat, 95)) * self.hedge_factor

    def fetch(self, i: int):
        deadline = self._deadline()
        result: queue.Queue = queue.Queue()

        def worker(tag: str):
            t0 = time.monotonic()
            out = self.fetch_fn(i)
            result.put((tag, out, time.monotonic() - t0))

        t_primary = threading.Thread(target=worker, args=("primary",),
                                     daemon=True)
        t0 = time.monotonic()
        t_primary.start()
        hedged = False
        while True:
            timeout = None
            if deadline is not None and not hedged:
                timeout = max(1e-3, deadline - (time.monotonic() - t0))
            try:
                tag, out, dt = result.get(timeout=timeout)
                break
            except queue.Empty:
                # primary exceeded the straggler deadline: hedge
                hedged = True
                self.hedges_issued += 1
                threading.Thread(target=worker, args=("backup",),
                                 daemon=True).start()
        if tag == "backup":
            self.hedges_won += 1
        self._lat.append(time.monotonic() - t0)
        self._lat = self._lat[-256:]
        return out


class CameraBatcher:
    """Adapts Mez ``DeliveredFrame`` streams into fixed-size model batches
    (dropped frames are skipped -- at-most-once semantics end to end).

    Consumes either single v1 frames (``push``) or whole v2 ``FrameBatch``
    units (``push_batch``) -- the fan-in merge already happened broker-side,
    so batching here is just accumulation to the model's batch size.
    """

    def __init__(self, batch: int):
        self.batch = batch
        self._buf: list[np.ndarray] = []

    def push_batch(self, frame_batch) -> list[np.ndarray]:
        """Feed one ``FrameBatch``; returns every model batch it completed
        (possibly none, possibly several)."""
        out = []
        for d in frame_batch:
            b = self.push(d)
            if b is not None:
                out.append(b)
        return out

    def push(self, delivered) -> np.ndarray | None:
        if delivered.frame is None:
            return None
        self._buf.append(np.asarray(delivered.frame, dtype=np.float32))
        if len(self._buf) >= self.batch:
            # pad ragged knob-resized frames to the max shape in the batch
            hmax = max(f.shape[0] for f in self._buf)
            wmax = max(f.shape[1] for f in self._buf)
            out = np.zeros((self.batch, hmax, wmax) + self._buf[0].shape[2:],
                           np.float32)
            for i, f in enumerate(self._buf[: self.batch]):
                out[i, : f.shape[0], : f.shape[1]] = f
            self._buf = self._buf[self.batch:]
            return out
        return None
