"""Host→device input pipeline: epoch batching + prefetch on a side stream.

Port of ``ssrl_vit_mae_jepa_tpu/data/pipeline.py``:

- ``HostLoader`` is unchanged: the host only gathers raw **uint8 NHWC**
  batches from the memmap (augmentation runs on the device inside the
  step), the batch shape is static (the last partial batch is padded by
  wrap-around with ``weight`` 0), and an epoch's shuffle is
  ``np.random.default_rng((seed, epoch))``;
- ``device_prefetch`` keeps ``depth`` batches in flight from a background
  thread. On the card each batch is copied into pinned host memory and
  sent with ``non_blocking`` copies on a side CUDA stream; an event
  recorded there is what the consuming stream waits on before it uses the
  batch, and ``record_stream`` keeps the batch's memory from being reused
  while the consumer's work on it is queued. On the CPU the batches are
  handed over as tensors. The bounded-put and sentinel rules of the JAX
  prefetcher (``:85-169``) hold as they are. Under data parallelism each
  rank passes its own card (``cuda:LOCAL_RANK``, the task's device) and
  its loader's shard: a rank's batches never leave its card.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ssrl_vit_mae_jepa_torch.data.stl10 import STL10


class HostLoader:
    """Deterministic epoch iterator over a dataset subset.

    Yields dict batches: ``image`` (B, 96, 96, 3) uint8, ``label`` (B,) int32,
    ``weight`` (B,) float32 (0.0 on padding rows).
    """

    def __init__(self, dataset: STL10, indices: np.ndarray, batch_size: int,
                 shuffle: bool, seed: int = 73):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        #: batches in flight (mapped from the reference's ``num_workers``
        #: knob by the loader factories)
        self.prefetch_depth = 2

    @property
    def num_examples(self) -> int:
        return len(self.indices)

    def __len__(self) -> int:
        return -(-len(self.indices) // self.batch_size)

    def epoch(self, epoch_idx: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        idx = self.indices
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch_idx))
            idx = rng.permutation(idx)
        b = self.batch_size
        for i in range(len(self)):
            sel = idx[i * b: (i + 1) * b]
            real = len(sel)
            if real < b:
                pad = np.resize(sel, b - real)  # wrap-around fill, weight 0
                sel = np.concatenate([sel, pad])
            images = self.dataset.images_nhwc(sel)
            labels = self.dataset.labels[sel].astype(np.int32)
            weight = np.zeros(len(sel), np.float32)
            weight[:real] = 1.0
            yield {"image": images, "label": labels, "weight": weight}


def _to_cuda(batch: Dict[str, np.ndarray], device: torch.device,
             stream: torch.cuda.Stream):
    """Pinned copies of the host arrays, sent on ``stream``; returns the
    device batch and the event that marks the copies done."""
    pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
              for k, v in batch.items()}
    with torch.cuda.stream(stream):
        out = {k: v.to(device, non_blocking=True) for k, v in pinned.items()}
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def device_prefetch(iterator: Iterator[Dict[str, np.ndarray]], device="cuda",
                    depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Background-thread prefetcher: up to ``depth`` batches ahead on
    ``device``."""
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    if on_cuda:
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.Stream(device)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    err: list = []
    stop = threading.Event()

    def put(batch):
        if on_cuda:
            return _to_cuda(batch, device, stream)
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}, None

    def worker():
        try:
            if on_cuda:
                torch.cuda.set_device(device)
            for batch in iterator:
                item = put(batch)
                # bounded put: if the consumer abandons the generator the
                # thread must exit instead of pinning depth + 1 batches
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except Exception as e:  # propagated to the consumer below
            err.append(e)
        finally:
            # bounded put for the sentinel too: never discard a queued batch
            # to make room; give up only if the consumer abandoned us
            while True:
                try:
                    q.put(_END, timeout=0.2)
                    break
                except queue.Full:
                    if stop.is_set():
                        break

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            batch, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(done)
                for v in batch.values():
                    v.record_stream(consumer)
            yield batch
    finally:
        # consumer done or abandoned: release the worker, drop its queued
        # batches, wait for it to exit, then drain what landed meanwhile
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=2.0)
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
