"""Chip dataset loader: shuffled, epoch-based batching over chip lists —
the asynchronous-CPU-dataloading role the paper assigns to its CPU
allocations, single-process here.  ``prefetch`` overlaps host batch
assembly with device compute through a background thread that stages each
batch onto the device.

The port's own copy of ``repro.data.loader``: :class:`ChipLoader` draws
its permutation from the same numpy generator, so its batches come in the
reference's order.  In ``prefetch``, ``tensor.to(device,
non_blocking=True)`` from pinned host memory takes the place of
``jax.device_put``."""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.chipping import Chip


class ChipLoader:
    def __init__(self, chips: Sequence[Chip], batch_size: int,
                 seed: int = 0, drop_last: bool = True):
        if not chips:
            raise ValueError("empty chip set")
        self.chips = list(chips)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.chips) // self.batch_size
        if not self.drop_last and len(self.chips) % self.batch_size:
            n += 1
        return n

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self.rng.permutation(len(self.chips))
        bs = self.batch_size
        stop = len(idx) - (len(idx) % bs if self.drop_last else 0)
        for i in range(0, stop, bs):
            sel = idx[i:i + bs]
            imgs = np.stack([self.chips[j].image for j in sel])
            masks = np.stack([self.chips[j].mask for j in sel])
            yield imgs.astype(np.float32), masks.astype(np.int32)


def _stage(batch, device: torch.device):
    """A batch (numpy arrays in tuples, lists or dicts) as tensors on
    ``device``; a copy to a card starts from pinned memory and does not
    wait for the card."""
    if isinstance(batch, dict):
        return {k: _stage(v, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_stage(v, device) for v in batch)
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch(loader, n: int = 2, device="cpu") -> Iterator:
    """Double-buffered prefetch: a background thread assembles the next
    ``n`` batches and stages them onto ``device``, so host batch assembly
    overlaps device compute.

    ``loader`` is a :class:`ChipLoader` (its ``epoch()`` is consumed) or
    any iterable of batches of host arrays (tuples, lists or dicts).
    Yields device-resident batches in order; producer exceptions re-raise
    at the consumer.  Closing the generator early (break / GeneratorExit)
    unblocks and stops the producer thread so queued device batches are
    released.
    """
    device = torch.device(device)
    it = loader.epoch() if hasattr(loader, "epoch") else iter(loader)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, n))
    stop = threading.Event()
    END, ERR = object(), object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in it:
                if not put(_stage(batch, device)):
                    return
            put(END)
        except BaseException as e:  # surfaced on the consumer side
            put((ERR, e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is END:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is ERR:
                raise item[1]
            yield item
    finally:
        stop.set()
        while not q.empty():   # drop staged batches so buffers free
            try:
                q.get_nowait()
            except queue.Empty:
                break
