"""Input pipelines (data/pipeline.py in the JAX package). Batches are
dicts on the training device: image (N, S, S, 3) uint8, mask (N, S, S, 1)
uint8 in {0, 1}, valid (N,) float32. A short last batch is padded and
`valid` marks the pad; the padded samples still go through the network
(and count in BatchNorm's statistics), the loss and metrics weight them
out. Each epoch's order is np.random.default_rng(seed + epoch)'s shuffle,
as in the JAX package.

  DeviceDataPipeline  the whole uint8 corpus resident on the card, masks
                      bit-packed 8 to a byte where the width allows; each
                      batch is a gather there; the pad repeats sample
                      index 0, as JAX's DeviceDataPipeline
  DataPipeline        the host path: worker threads load samples, a
                      producer thread assembles pinned uint8 batches and
                      copies them with non_blocking while the loop computes;
                      the pad is zero rows (parallel/mesh.pad_batch_to), as
                      JAX's DataPipeline. Over a mesh of n ranks the batch
                      is padded to a multiple of n and each rank loads only
                      its contiguous share of the rows
                      (parallel/distributed.process_batch_slice), every
                      rank in the same epoch order

make_pipelines picks the resident one in a world of one where
DATA.DEVICE_CACHE is set and the corpus fits DATA.DEVICE_CACHE_MB.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from ..parallel.distributed import process_batch_slice
from ..parallel.mesh import pad_batch_to

logger = logging.getLogger(__name__)


def _binary(mask: np.ndarray) -> np.ndarray:
    return (mask > (127 if mask.dtype == np.uint8 else 0.5)).astype(np.uint8)


def _order(n: int, shuffle: bool, seed: int, epoch: int) -> np.ndarray:
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(idx)
    return idx


def _chunks(idx: np.ndarray, bs: int, drop_remainder: bool):
    """The indices of each batch of the epoch order `idx`; the last may be
    short (dropped under drop_remainder). Each pipeline pads it its own
    way."""
    for i in range(0, len(idx), bs):
        chunk = idx[i:i + bs]
        if len(chunk) < bs and drop_remainder:
            return
        yield chunk


def unpack_mask_bits(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of np.packbits(axis=-1) (big bit order): (..., S, S // 8)
    uint8 → (..., S, S) uint8 in {0, 1}."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))


class DeviceDataPipeline:
    """The decoded uint8 dataset uploaded to `device` once (on the first
    iteration), then every batch a gather there."""

    def __init__(self, dataset, batch_size: int, device, shuffle: bool = True,
                 seed: int = 42, drop_remainder: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0
        self.images = None  # (N, S, S, 3) uint8 on the device
        self.masks = None   # (N, S, S) or bit-packed (N, S, S // 8) uint8
        self.masks_packed = False

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def ensure_device(self) -> None:
        if self.images is not None:
            return
        t0 = time.time()
        imgs, msks = [], []
        for i in range(len(self.dataset)):
            im, mk = self.dataset[i]
            imgs.append(np.asarray(im, dtype=np.uint8))
            msks.append(_binary(np.asarray(mk)))
        host_i, host_m = np.stack(imgs), np.stack(msks)
        if host_m.shape[-1] % 8 == 0:
            host_m = np.packbits(host_m, axis=-1)  # 8 mask pixels a byte
            self.masks_packed = True
        self.images = torch.from_numpy(host_i).to(self.device)
        self.masks = torch.from_numpy(host_m).to(self.device)
        logger.info("device-resident dataset: %d samples, %.2f GB uint8 "
                    "uploaded in %.1fs%s", len(imgs),
                    (host_i.nbytes + host_m.nbytes) / 2 ** 30,
                    time.time() - t0,
                    " (masks bit-packed)" if self.masks_packed else "")

    def gather(self, idx: torch.Tensor) -> dict:
        m = self.masks.index_select(0, idx)
        if self.masks_packed:
            m = unpack_mask_bits(m)
        return {"image": self.images.index_select(0, idx),
                "mask": m[..., None]}

    def __iter__(self) -> Iterator[dict]:
        self.ensure_device()
        order = _order(len(self.dataset), self.shuffle, self.seed,
                       self._epoch)
        self._epoch += 1
        bs = self.batch_size
        batches = []
        for chunk in _chunks(order, bs, self.drop_remainder):
            valid = np.zeros((bs,), np.float32)
            valid[:len(chunk)] = 1.0
            # the pad repeats index 0, as JAX's DeviceDataPipeline
            batches.append((np.pad(chunk, (0, bs - len(chunk))), valid))
        if not batches:
            return
        # the epoch's indices and valid flags go up in one copy (a copy
        # from the host blocks it), not one a batch
        idx, valid = (torch.from_numpy(np.stack(a)).to(self.device)
                      for a in zip(*batches))
        for i in range(len(batches)):
            batch = self.gather(idx[i])
            batch["valid"] = valid[i]
            yield batch


def _assemble(samples) -> dict:
    return {"image": np.stack([s[0] for s in samples]).astype(np.uint8),
            "mask": np.stack([_binary(np.asarray(s[1]))
                              for s in samples])[..., None]}


class DataPipeline:
    """Epoch iterator over host-loaded samples: a pool of `num_workers`
    threads loads each batch's samples, a producer thread stacks them into
    pinned memory (on a CUDA device) and starts the non_blocking copy, up
    to `prefetch` batches ahead. Over a `mesh` (parallel/mesh.Mesh) each
    batch is padded to a multiple of its size and this rank yields its
    rows of it."""

    def __init__(self, dataset, batch_size: int, device, shuffle: bool = True,
                 seed: int = 42, num_workers: int = 8, prefetch: int = 2,
                 drop_remainder: bool = False, mesh=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_remainder = drop_remainder
        self._epoch = 0
        # padded batch: a multiple of the mesh's size, so every rank gets
        # an equal share; `valid` covers the extra rows
        self.mesh = mesh
        ndev = 1 if mesh is None else mesh.size
        self.padded_batch_size = -(-batch_size // ndev) * ndev
        self._no_rows = None  # zero-row image and mask of the samples' shapes

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _load(self, pool, chunk: np.ndarray) -> dict:
        """This rank's rows of the padded batch over `chunk`: its real
        samples, then zero rows, and their `valid`."""
        n = self.padded_batch_size
        local, start, end = (process_batch_slice(n) if self.mesh is not None
                             else (n, 0, n))
        mine = chunk[start:end]
        if len(mine):
            host = _assemble(list(pool.map(self.dataset.__getitem__,
                                           mine.tolist())))
            self._no_rows = {k: v[:0] for k, v in host.items()}
        else:  # every row of this rank's share is pad
            if self._no_rows is None:  # nothing loaded yet: sample 0's shapes
                self._no_rows = {k: v[:0] for k, v in
                                 _assemble([self.dataset[0]]).items()}
            host = self._no_rows
        host, _ = pad_batch_to(host, local)
        valid = np.zeros((n,), np.float32)
        valid[:len(chunk)] = 1.0
        host["valid"] = valid[start:end]
        return host

    def _to_device(self, host: dict) -> dict:
        pin = self.device.type == "cuda"
        out = {}
        for k, v in host.items():
            t = torch.from_numpy(v)
            if pin:
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=pin)
        return out

    def __iter__(self) -> Iterator[dict]:
        order = _order(len(self.dataset), self.shuffle, self.seed,
                       self._epoch)
        self._epoch += 1
        batches = list(_chunks(order, self.batch_size, self.drop_remainder))
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for chunk in batches:
                        if stop.is_set():
                            return
                        if not put(self._to_device(self._load(pool, chunk))):
                            return
                put(None)
            except Exception as e:  # noqa: BLE001 — raised in the consumer
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def _device_cache_fits(cfg, *datasets) -> bool:
    budget = cfg.DATA.DEVICE_CACHE_MB * (1 << 20)
    s = cfg.DATA.IMG_SIZE
    return sum(len(d) for d in datasets) * s * s * 4 <= budget


def make_pipelines(cfg, train_ds, val_ds, device, mesh=None
                   ) -> Tuple[object, object]:
    """(train, val) pipelines on `device`; over a mesh of more than one
    rank the host DataPipeline, as in the JAX package."""
    ndev = 1 if mesh is None else mesh.size
    if cfg.DATA.DEVICE_CACHE and ndev == 1 and _device_cache_fits(
            cfg, train_ds, val_ds):
        return (DeviceDataPipeline(train_ds, cfg.TRAIN.BATCH_SIZE, device,
                                   shuffle=True, seed=cfg.DATA.SEED),
                DeviceDataPipeline(val_ds, cfg.TRAIN.BATCH_SIZE, device,
                                   shuffle=False, seed=cfg.DATA.SEED))
    kw = dict(seed=cfg.DATA.SEED, num_workers=cfg.DATA.NUM_WORKERS,
              prefetch=cfg.DATA.PREFETCH_FACTOR, mesh=mesh)
    return (DataPipeline(train_ds, cfg.TRAIN.BATCH_SIZE, device,
                         shuffle=True, **kw),
            DataPipeline(val_ds, cfg.TRAIN.BATCH_SIZE, device,
                         shuffle=False, **kw))
