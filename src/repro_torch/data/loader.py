"""Prefetching host-to-device data feed (port of ``repro.data.loader``).

Training data stays where it is made; only fresh batches cross to the
device, staged one step ahead on a background thread so the feed overlaps
compute.  The reference places batches with ``jax.device_put`` and
shardings; the port places each array of a batch dict on one ``device``.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Union

import numpy as np
import torch


class PrefetchLoader:
    """Wraps a host batch source (a callable returning a dict of arrays);
    a daemon thread turns each batch into tensors on ``device`` (the
    CPU when None) and keeps up to ``prefetch`` of them queued."""

    def __init__(self, source: Callable[[], dict],
                 device: Optional[Union[str, torch.device]] = None,
                 prefetch: int = 2):
        self.source = source
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device,
                                                     non_blocking=True)
                for k, v in batch.items()}

    def _worker(self):
        while not self._stop.is_set():
            batch = self._place(self.source())
            # retry until the consumer catches up or the loader closes
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    pass

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
