"""Host-side data loader with per-process sharding and thread prefetch.

TPU-native replacement for torch DataLoader + DistributedSampler
(reference: utils/dat_utils.py:25-70). Each JAX *process* (host) loads
its shard of the global batch; inside a process the batch is later
sharded across local devices by the mesh. Deterministic per-epoch
shuffling mirrors DistributedSampler(set_epoch) semantics.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np


def stack_collate(batch: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """List[Dict[k, arr]] -> Dict[k, stacked arr]
    (reference: dat_utils.py:81-109)."""
    out: Dict[str, np.ndarray] = {}
    keys = list(batch[0].keys())
    for k in keys:
        shape = np.asarray(batch[0][k]).shape
        for b in batch:
            assert np.asarray(b[k]).shape == shape, (
                f"ragged batch for key {k}: {np.asarray(b[k]).shape} vs {shape}"
            )
        out[k] = np.stack([np.asarray(b[k]) for b in batch])
    return out


_FRAME_KEYS = ("frms_ev_fast_tensor", "frms_ev_slow_tensor")


def fold_frame_events(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Fold the 5-event axis of the frame tensors into the batch axis on
    the HOST: (B, 5, T, H, W, C) -> (B*5, T, H, W, C), a free
    C-contiguous numpy view.

    Doing the fold in-graph materializes a full copy of the frames (XLA
    lays the folded tensor out batch-minor, so the reshape cannot be a
    bitcast — ~11 ms at 120 clips on v5e, benchmarks/micro20); the model
    (models/vb_models._fold_events) accepts either form. Other keys
    (labels etc.) keep their (B, ...) shape — the model realigns via the
    row order, which the fold preserves.
    """
    out = dict(batch)
    for k in _FRAME_KEYS:
        v = out.get(k)
        if v is not None and getattr(v, "ndim", 0) == 6:
            arr = np.asarray(v)
            out[k] = arr.reshape((arr.shape[0] * arr.shape[1],) + arr.shape[2:])
    return out


class ShardedSampler:
    """Deterministic shuffled/sequential index sampler over dataset shards.

    Pads the index list so every shard gets the same count (like
    torch's DistributedSampler), which keeps per-host batch shapes static
    — a requirement for jit-compiled steps.
    """

    def __init__(
        self,
        n: int,
        shuffle: bool,
        num_shards: int = 1,
        shard_id: int = 0,
        seed: int = 0,
    ):
        assert 0 <= shard_id < num_shards
        self.n = n
        self.shuffle = shuffle
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(self.n)
        else:
            order = np.arange(self.n)
        total = ((self.n + self.num_shards - 1) // self.num_shards) * self.num_shards
        if total > self.n:
            # repeat the order as many times as needed: with more shards
            # than samples a single wrap would leave some shards EMPTY
            # while __len__ still reports one item (torch's
            # DistributedSampler repeats the same way) — on a multi-host
            # run an empty shard means that host skips the collective
            # train step and the cluster hangs
            pad = total - self.n
            reps = (pad + self.n - 1) // self.n
            order = np.concatenate([order] + [order] * reps)[:total]
        return iter(order[self.shard_id :: self.num_shards].tolist())

    def __len__(self) -> int:
        return (self.n + self.num_shards - 1) // self.num_shards


class DataLoader:
    """Batched iterator with optional background prefetch threads."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
        num_shards: int = 1,
        shard_id: int = 0,
        seed: int = 0,
        prefetch: int = 2,
        num_threads: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.collate_fn = collate_fn or stack_collate
        self.sampler = ShardedSampler(
            len(dataset), shuffle, num_shards, shard_id, seed
        )
        self.prefetch = prefetch
        self.num_threads = num_threads
        self._pool = None  # lazy persistent item-fetch pool

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    def _item_pool(self):
        # JPEG decode (PIL) releases the GIL, so a thread pool gives real
        # parallel frame decoding — the reference's nw dataloader workers
        # (configs/vsitu_cfg.yml:91) without process boundaries
        if self._pool is None and self.num_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.num_threads)
        return self._pool

    def _batch_indices(self) -> List[List[int]]:
        idxs = list(self.sampler)
        batches = [
            idxs[i : i + self.batch_size]
            for i in range(0, len(idxs), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __len__(self) -> int:
        nb, rem = divmod(len(self.sampler), self.batch_size)
        if rem and not self.drop_last:
            nb += 1
        return nb

    def _make_batch(self, bidx: List[int]) -> Dict[str, np.ndarray]:
        pool = self._item_pool()
        if pool is not None and len(bidx) > 1:
            items = list(pool.map(self.dataset.__getitem__, bidx))
        else:
            items = [self.dataset[i] for i in bidx]
        return self.collate_fn(items)

    def __iter__(self):
        batches = self._batch_indices()
        if self.num_threads <= 0:
            for bidx in batches:
                yield self._make_batch(bidx)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # never block forever: if the consumer abandoned iteration
            # (e.g. a single next(iter(dl)) warm-up, or an exception
            # unwinding the epoch loop) the generator's finally sets
            # `stop`, and a plain q.put on a full queue would pin this
            # thread and its decoded batches for the rest of the process
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for bidx in batches:
                    if stop.is_set():
                        break
                    if not put_or_stop(self._make_batch(bidx)):
                        return
            except BaseException as e:  # surface worker errors to consumer
                put_or_stop(e)
            finally:
                put_or_stop(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


@dataclass
class DataWrap:
    path: Any
    train_dl: Any
    valid_dl: Any
    test_dl: Any = None


def get_dataloader(cfg, dataset, is_train: bool, num_shards=1, shard_id=0):
    """Split the global batch across processes
    (reference: dat_utils.py:36-70 — bs // num_gpus per rank)."""
    bs_global = cfg.train.bs if is_train else cfg.train.bsv
    assert bs_global % num_shards == 0, (
        f"global batch {bs_global} not divisible by {num_shards} processes"
    )
    return DataLoader(
        dataset,
        batch_size=bs_global // num_shards,
        shuffle=is_train and cfg.ds.trn_shuffle,
        drop_last=is_train,
        num_shards=num_shards,
        shard_id=shard_id,
        seed=cfg.train.seed,
        num_threads=cfg.train.nw if is_train else cfg.train.nwv,
    )


def get_data(cfg, num_shards: int = 1, shard_id: int = 0) -> DataWrap:
    """Build train/valid(/test) datasets + loaders
    (reference: dat_loader.py:585-616)."""
    from .dataset import VsituDS

    train_ds = VsituDS(cfg, {}, split_type="train")
    valid_ds = VsituDS(cfg, train_ds.comm, split_type="valid")
    test_ds = None
    if cfg.only_test:
        split_map = {"vb": "test_verb", "vb_arg": "test_srl", "evrel": "test_evrel"}
        test_ds = VsituDS(cfg, train_ds.comm, split_type=split_map[cfg.task_type])

    train_dl = get_dataloader(cfg, train_ds, True, num_shards, shard_id)
    valid_dl = get_dataloader(cfg, valid_ds, False, num_shards, shard_id)
    test_dl = (
        get_dataloader(cfg, test_ds, False, num_shards, shard_id)
        if test_ds is not None
        else None
    )
    return DataWrap(
        path=cfg.misc.tmp_path,
        train_dl=train_dl,
        valid_dl=valid_dl,
        test_dl=test_dl,
    )
