"""Batch loader: threaded prefetch in place of torch's DataLoader worker
pool (reference data/__init__.py:41-54); the port's copy of
cocosnet_tpu/data/loader.py.

A thread pool decodes and augments the items of two batches at a time (PIL
releases the GIL for the heavy parts) and collates their HWC numpy arrays
into NHWC batches. Each item's random draws (crop, flip, exemplar) are
made on the calling thread in index order before its decode is handed to
the pool, so a seed gives the same items at any thread count: the items
of the JAX package's loader on one thread. `to_device` then copies each
batch from pinned host memory to the card without waiting for the copy,
so the host goes on to the next batch while the device computes; the
one-hot scatter happens in pix2pix.preprocess_input.
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from cocosnet_tpu_torch.config import Options
from cocosnet_tpu_torch.mesh import process_shard


def collate(items: List[Dict]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], str):
            out[key] = vals  # paths stay host-side
        else:
            out[key] = np.stack(vals).astype(np.float32)
    return out


class DataLoader:
    """Iterates epoch batches: shuffle (unless serial_batches), drop_last in
    training (data/__init__.py:47-53). The shuffle is seeded by opt.seed
    only, so a run's batch order is the JAX package's, and so are its
    items (the JAX package's on one thread).

    Across data ranks (process_count > 1: the mesh's data axis), every rank
    builds the same global batch order and loads its contiguous
    `process_shard` of each global batch, so batchSize stays the global
    batch; in evaluation the ragged last batch is padded with wrap-around
    duplicates so that it splits across the ranks (cocosnet_tpu/data/
    loader.py:45-99). Each rank's dataset draws for its own items only,
    from its own generator seeded with opt.seed, in index order: the JAX
    package's loader on the same process index and count draws the same."""

    def __init__(self, dataset, opt: Options, process_index: int = 0,
                 process_count: int = 1):
        self.dataset = dataset
        self.opt = opt
        self.batch_size = opt.batchSize
        self.shuffle = not opt.serial_batches
        self.drop_last = opt.isTrain
        self.rng = random.Random(opt.seed)
        self.workers = max(1, min(opt.nThreads, 8))
        self.process_index = process_index
        self.process_count = process_count
        self._shard = process_shard(self.batch_size, process_index,
                                    process_count)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(indices)
        if self.drop_last:
            indices = indices[: len(self) * self.batch_size]
        batches = [indices[i: i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.process_count > 1:
            start, size = self._shard
            ragged = [b for b in batches if len(b) != self.batch_size]
            if ragged and not self.drop_last:
                # pad the eval tail batch (wrap-around duplicates) so every
                # sample is covered; duplicates re-save the same output path
                tail = ragged[0]
                pad = self.batch_size - len(tail)
                print(f"DataLoader: padding final eval batch with {pad} "
                      f"duplicate item(s) to split across "
                      f"{self.process_count} processes")
                tail.extend(indices[:pad] if len(indices) >= pad
                            else tail * pad)
                tail[:] = tail[: self.batch_size]
            batches = [b[start: start + size] for b in batches
                       if len(b) == self.batch_size]

        if self.workers <= 1:
            for batch_idx in batches:
                yield collate([self.dataset[i] for i in batch_idx])
            return

        with ThreadPoolExecutor(self.workers) as pool:
            depth = 2  # batches in flight

            def submit(batch_idx):
                return [pool.submit(self.dataset.load, i,
                                    self.dataset.draw(i))
                        for i in batch_idx]

            it = iter(batches)
            inflight = []
            for _ in range(depth):
                b = next(it, None)
                if b is not None:
                    inflight.append(submit(b))
            while inflight:
                futures = inflight.pop(0)
                b = next(it, None)
                if b is not None:
                    inflight.append(submit(b))
                yield collate([f.result() for f in futures])


def to_device(batch: Dict, device: torch.device
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, list]]:
    """(arrays, paths) of one collated batch: the arrays as tensors on
    `device` (to a CUDA device copied from pinned host memory with
    non_blocking=True, so the host goes on while the copy runs), the paths
    as they were."""
    pin = device.type == "cuda"
    arrays, paths = {}, {}
    for k, v in batch.items():
        if isinstance(v, list):
            paths[k] = v
            continue
        t = torch.from_numpy(v)
        if pin:
            t = t.pin_memory()
        arrays[k] = t.to(device, non_blocking=pin)
    return arrays, paths


def dataset_registry():
    """Name -> class, in place of the reference's reflection-based lookup
    (data/__init__.py:11-33)."""
    from cocosnet_tpu_torch.data.ade20k import ADE20KDataset
    from cocosnet_tpu_torch.data.celebahq import CelebAHQDataset
    from cocosnet_tpu_torch.data.celebahqedge import CelebAHQEdgeDataset
    from cocosnet_tpu_torch.data.deepfashion import DeepFashionDataset
    from cocosnet_tpu_torch.data.flickr import FlickrDataset

    return {"ade20k": ADE20KDataset, "celebahq": CelebAHQDataset,
            "celebahqedge": CelebAHQEdgeDataset,
            "deepfashion": DeepFashionDataset, "flickr": FlickrDataset}


def create_dataloader(opt: Options, process_index: int = 0,
                      process_count: int = 1) -> DataLoader:
    """Registry dispatch (data/__init__.py:41-54); process_index and
    process_count: this process's data rank and the data axis's size."""
    registry = dataset_registry()
    if opt.dataset_mode not in registry:
        raise ValueError(
            f"dataset_mode {opt.dataset_mode!r} not in {sorted(registry)}")
    dataset = registry[opt.dataset_mode](opt)
    print(f"dataset [{type(dataset).__name__}] of size {len(dataset)} was created")
    return DataLoader(dataset, opt, process_index, process_count)
