"""Checkpoint writes off the train loop (utils/async_ckpt.py in the JAX
package): a save is a host snapshot of the state (training/checkpoint
.snapshot, a copy, so the loop may go on updating the live tensors) and a
job on ONE worker thread that writes it. Jobs run in order; flush() waits
for them and raises the first error a job raised."""
from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, List, Optional

logger = logging.getLogger(__name__)


class AsyncSaver:
    """One background worker running queued save jobs in order; at most
    `max_pending` jobs wait behind the running one."""

    def __init__(self, max_pending: int = 1):
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._errors: List[BaseException] = []
        self._thread: Optional[threading.Thread] = None

    def _ensure_worker(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def _run(self):
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                fn, args, kwargs = job
                fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — raised in flush
                logger.warning("async checkpoint save failed: %s", e)
                self._errors.append(e)
            finally:
                job = None  # drop the snapshot before waiting again
                self._q.task_done()

    def submit(self, fn: Callable, *args, **kwargs) -> None:
        """Queue fn(*args, **kwargs); blocks while max_pending wait."""
        self._ensure_worker()
        self._q.put((fn, args, kwargs))

    def flush(self, raise_errors: bool = True) -> None:
        """Wait for every queued save; raise the first worker error."""
        self._q.join()
        if raise_errors and self._errors:
            err, self._errors = self._errors[0], []
            raise err

    def close(self) -> None:
        self.flush(raise_errors=False)
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=30)
