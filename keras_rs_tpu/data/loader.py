"""Threaded host-side data pipeline.

Parity with the reference's `ThreadedDataLoader`
(examples/ml_perf/main.py:35-105): N worker threads pull raw batches from
a source iterator and run the (CPU-heavy) embedding `preprocess` while the
device trains on earlier batches; results queue in a bounded buffer.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator


class ThreadedDataLoader:
    """Prefetching loader running `preprocess_fn` in worker threads.

    Note: batch ORDER is not preserved across workers (matching the
    reference, whose workers also complete out of order); recommender
    training is order-insensitive within a shuffle.
    """

    _DONE = object()

    def __init__(
        self,
        source: Iterator[Any],
        preprocess_fn: Callable[[Any], Any],
        *,
        num_workers: int = 4,
        buffer_size: int = 8,
    ) -> None:
        self._source = iter(source)
        self._preprocess = preprocess_fn
        self._out: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._source_lock = threading.Lock()
        self._exhausted = False
        self._error: BaseException | None = None
        self._workers = [
            threading.Thread(target=self._work, daemon=True)
            for _ in range(num_workers)
        ]
        self._live_workers = len(self._workers)
        self._live_lock = threading.Lock()
        for w in self._workers:
            w.start()

    def stop(self) -> None:
        """Stops the workers (no more batches are pulled from the source).

        Call when training ends before the source is exhausted (e.g. an
        infinite stream); otherwise daemon workers keep preprocessing
        through interpreter shutdown.
        """
        with self._source_lock:
            self._exhausted = True
        # Unblock workers stuck on a full queue.
        while True:
            try:
                self._out.get_nowait()
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def _next_raw(self):
        with self._source_lock:
            if self._exhausted:
                return self._DONE
            try:
                return next(self._source)
            except StopIteration:
                self._exhausted = True
                return self._DONE

    def _work(self) -> None:
        try:
            while True:
                raw = self._next_raw()
                if raw is self._DONE:
                    break
                self._out.put(self._preprocess(raw))
        except BaseException as e:  # propagate to consumer
            self._error = e
        finally:
            with self._live_lock:
                self._live_workers -= 1
                if self._live_workers == 0:
                    self._out.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._out.get()
        if item is self._DONE:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item
