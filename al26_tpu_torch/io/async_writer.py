"""Asynchronous checkpoint writing (the port's copy of
al26_tpu/io/async_writer.py).

The reference writes checkpoints inline on the driver thread
(save_checkpoint, al26_nbody.py:347-401) — the simulation stalls for the
pickle + zstd + disk time of every save (~10-100 ms, growing with the
yields store). Here saves can be handed to a single background worker
thread so the next physics chunk's device computation overlaps the host
serialisation. The device->host copy stays on the driver thread
(state.cluster_to_numpy before submit): a job never holds a CUDA tensor.

Design constraints honoured:
  * ORDERING — one worker, FIFO queue: saves land on disk in submission
    order, so `<base>-state-NNNNN` numbering, the append-only CSV and the
    yields store all stay sequential exactly as in the synchronous path.
  * ERRORS — an exception in a save job (including the checkpoint-time
    state validation, utils/validate.py) is captured and re-raised on the
    driver thread at the next submit()/flush(), never swallowed.
  * SHARED STATE — Yields / Metadata objects are mutated by the jobs;
    the driver must not touch them between submit() and flush(). The run
    driver only reads them after the final flush().
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class AsyncCheckpointWriter:
    """Single-threaded ordered executor for checkpoint jobs."""

    _SENTINEL = object()

    def __init__(self) -> None:
        # bounded queue: a writer slower than the compute cadence must
        # BACKPRESSURE submit() (each pending job pins a full gathered
        # host copy of the cluster) instead of growing the backlog to OOM
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._error: Optional[BaseException] = None
        # epoch scheme: every job carries the epoch it was submitted in,
        # and a failure poisons ITS epoch — jobs already queued behind the
        # failed one (same epoch) drain without running even after
        # _reraise clears _error (previously a queued save could race the
        # driver's re-raise and write a checkpoint on top of the torn
        # one), while jobs submitted AFTER the re-raise (next epoch) run,
        # keeping the writer usable.
        self._epoch = 0
        self._bad_epoch = -1
        self._thread = threading.Thread(
            target=self._loop, name="al26-ckpt-writer", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is self._SENTINEL:
                    return
                epoch, job = item
                if epoch != self._bad_epoch:
                    job()
            except BaseException as e:  # noqa: BLE001 — must cross threads
                self._error = e
                self._bad_epoch = epoch
            finally:
                self._q.task_done()

    def _reraise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            self._epoch += 1  # subsequent submissions form a fresh epoch
            raise RuntimeError(
                "asynchronous checkpoint save failed (state shown is from "
                "an earlier step; see cause)"
            ) from err

    def submit(self, job: Callable[[], None]) -> None:
        """Enqueue a save job; re-raises any earlier job's failure."""
        self._reraise()
        self._q.put((self._epoch, job))

    def flush(self) -> None:
        """Block until every enqueued job has run; re-raise failures."""
        self._q.join()
        self._reraise()

    def close(self) -> None:
        """Flush and stop the worker thread."""
        self._q.join()
        self._q.put(self._SENTINEL)
        self._thread.join()
        self._reraise()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        # on an exception already unwinding, still try to stop cleanly but
        # don't mask it with a writer error
        try:
            self.close()
        except RuntimeError:
            if exc == (None, None, None):
                raise
