"""Host-side data pipeline of training: token streams and prefetch.

The port of the JAX package's ``data/pipeline.py`` for what the training
loop reads, copied as it is (NumPy and threads only):
``TokenStream`` generates deterministic synthetic LM batches (zipfian
token ids with repeated phrases a model can learn), the same batches as
the JAX package's for the same seed; ``Prefetcher`` keeps a bounded queue
of ready batches filled by a producer thread, so the training loop never
waits on the host.  ``BackupFetcher`` (straggler hedging) and
``CameraBatcher`` (Mez subscriptions into model batches) wait for ROADMAP
Queue 1 item 7.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["TokenStream", "Prefetcher"]


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
