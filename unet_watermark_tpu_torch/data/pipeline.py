"""Input pipelines (data/pipeline.py in the JAX package). Batches are
dicts on the training device: image (N, S, S, 3) uint8, mask (N, S, S, 1)
uint8 in {0, 1}, valid (N,) float32. A short last batch is padded with
sample index 0 and `valid` marks the pad; the padded samples still go
through the network (and count in BatchNorm's statistics), the loss and
metrics weight them out. Each epoch's order is
np.random.default_rng(seed + epoch)'s shuffle, as in the JAX package.

  DeviceDataPipeline  the whole uint8 corpus resident on the card, masks
                      bit-packed 8 to a byte where the width allows; each
                      batch is a gather there
  DataPipeline        the host path: worker threads load samples, a
                      producer thread assembles pinned uint8 batches and
                      copies them with non_blocking while the loop computes

make_pipelines picks the resident one where DATA.DEVICE_CACHE is set and
the corpus fits DATA.DEVICE_CACHE_MB.
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

logger = logging.getLogger(__name__)


def _binary(mask: np.ndarray) -> np.ndarray:
    return (mask > (127 if mask.dtype == np.uint8 else 0.5)).astype(np.uint8)


def _order(n: int, shuffle: bool, seed: int, epoch: int) -> np.ndarray:
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(idx)
    return idx


def _chunks(idx: np.ndarray, bs: int, drop_remainder: bool):
    """(indices, valid) of each batch, the last padded with index 0."""
    for i in range(0, len(idx), bs):
        chunk = idx[i:i + bs]
        valid = np.ones((bs,), np.float32)
        if len(chunk) < bs:
            if drop_remainder:
                return
            valid[len(chunk):] = 0.0
            chunk = np.concatenate(
                [chunk, np.zeros((bs - len(chunk),), chunk.dtype)])
        yield chunk, valid


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
        batches = list(_chunks(order, self.batch_size, self.drop_remainder))
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


class DataPipeline:
    """Epoch iterator over host-loaded samples: a pool of `num_workers`
    threads loads each batch's samples, a producer thread stacks them into
    pinned memory (on a CUDA device) and starts the non_blocking copy, up
    to `prefetch` batches ahead."""

    def __init__(self, dataset, batch_size: int, device, shuffle: bool = True,
                 seed: int = 42, num_workers: int = 8, prefetch: int = 2,
                 drop_remainder: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_remainder = drop_remainder
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

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
                    for chunk, valid in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__,
                                                chunk.tolist()))
                        host = {
                            "image": np.stack([s[0] for s in samples]
                                              ).astype(np.uint8),
                            "mask": np.stack([_binary(np.asarray(s[1]))
                                              for s in samples])[..., None],
                            "valid": valid}
                        if not put(self._to_device(host)):
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


def make_pipelines(cfg, train_ds, val_ds, device
                   ) -> Tuple[object, object]:
    """(train, val) pipelines on `device`."""
    if cfg.DATA.DEVICE_CACHE and _device_cache_fits(
            cfg, train_ds, val_ds):
        return (DeviceDataPipeline(train_ds, cfg.TRAIN.BATCH_SIZE, device,
                                   shuffle=True, seed=cfg.DATA.SEED),
                DeviceDataPipeline(val_ds, cfg.TRAIN.BATCH_SIZE, device,
                                   shuffle=False, seed=cfg.DATA.SEED))
    kw = dict(seed=cfg.DATA.SEED, num_workers=cfg.DATA.NUM_WORKERS,
              prefetch=cfg.DATA.PREFETCH_FACTOR)
    return (DataPipeline(train_ds, cfg.TRAIN.BATCH_SIZE, device,
                         shuffle=True, **kw),
            DataPipeline(val_ds, cfg.TRAIN.BATCH_SIZE, device,
                         shuffle=False, **kw))
