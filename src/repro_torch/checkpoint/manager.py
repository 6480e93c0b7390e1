"""Asynchronous checkpoint manager: a host snapshot, then a writer thread.

Port of ``src/repro/checkpoint/manager.py``.  The training loop calls
``maybe_save(step, state)``; the manager copies the state to the host
before returning and hands the file I/O to a background thread, so the
card keeps stepping while the previous checkpoint serialises.  The copy
is a clone: the port's AdamW updates parameters and moments in place
(:mod:`repro_torch.optim.adamw`), and on the CPU ``t.cpu()`` would be the
same storage, where the reference's ``device_get`` arrays are immutable.
``wait()`` drains pending writes; ``close()`` also stops the thread.
"""

from __future__ import annotations

import queue
import threading

import torch

from repro_torch.checkpoint import store


def host_copy(tree):
    """``tree`` with every tensor cloned to the host (dicts, tuples,
    ``NamedTuple``s and None kept as they are)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(host_copy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, root: str, *, every: int = 100, keep: int = 3):
        self.root = root
        self.every = every
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: list[BaseException] = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, state, extra = item
            try:
                store.save(self.root, step, state, extra=extra)
                store.retain(self.root, self.keep)
            except Exception as e:  # noqa: BLE001 — re-raised by the caller
                self._err.append(e)
            finally:
                self._q.task_done()

    def maybe_save(self, step: int, state, *, extra: dict | None = None,
                   force: bool = False) -> bool:
        if self._err:
            raise RuntimeError("checkpoint writer failed") from self._err[0]
        if not force and (step == 0 or step % self.every != 0):
            return False
        # Host snapshot now, so later in-place updates don't race the
        # writer.
        self._q.put((step, host_copy(state), extra))
        return True

    def wait(self):
        self._q.join()
        if self._err:
            raise RuntimeError("checkpoint writer failed") from self._err[0]

    def close(self):
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._worker.join(timeout=10)
