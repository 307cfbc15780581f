"""Host data pipeline: split, shuffle, batch, prefetch to the device.

Port of `sivae_tpu/data/pipeline.py:28-193`, which replaces the reference's
torch DataLoader with 4-28 worker processes + pin_memory (main.py:101-104,
z-1200main.py:120-123). The volumes live as one contiguous numpy array on
the host; each epoch is a seeded permutation; a background thread gathers
each batch into pinned memory, copies it to the device on a side stream and
augments and normalises it there, so the copy overlaps the previous step.

The split is the reference's scikit-learn StratifiedGroupKFold
(main.py:84-98): fold 4 of 5, grouped by pid so no patient spans train/val.

Under data parallelism (`sivae_torch/parallel/`) `batch_size` is the global
batch and every rank walks the same seeded order; each rank gathers, copies
and augments only its rows of each global batch (`local_batch_slice`), as
each JAX host feeds its shard (`sivae_tpu/parallel/distributed.py:48-54`).
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Callable, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sivae_torch.data.preprocess import preprocess_batch
from sivae_torch.parallel.distributed import local_batch_slice
from sivae_torch.utils.device import resolve_device


def grouped_split(
    labels: Sequence[int],
    groups: Sequence[str],
    n_splits: int = 5,
    split_index: int = 4,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """StratifiedGroupKFold split (reference main.py:84-98) -> (train_idx, val_idx)."""
    from sklearn.model_selection import StratifiedGroupKFold

    sgkf = StratifiedGroupKFold(n_splits=n_splits, shuffle=True, random_state=seed)
    splits = list(sgkf.split(np.zeros(len(labels)), labels, groups))
    return splits[split_index]


class BrainDataSource:
    """Records -> contiguous (voxels, labels) arrays."""

    def __init__(self, records: Sequence[dict]):
        self.voxels = np.stack([r["voxel"] for r in records]).astype(np.float32)
        self.labels = np.asarray([r["nu_label"] for r in records], np.int32)
        self.pids = [r["pid"] for r in records]

    def __len__(self) -> int:
        return len(self.labels)

    def subset(self, idx: np.ndarray) -> "BrainDataSource":
        out = object.__new__(BrainDataSource)
        out.voxels = self.voxels[idx]
        out.labels = self.labels[idx]
        out.pids = [self.pids[i] for i in idx]
        return out


Augment = Callable[[torch.Generator, torch.Tensor], torch.Tensor]
PREFETCH = 2   # batches in flight ahead of the consumer, one pinned buffer each


class DataPipeline:
    """Epoch iterator yielding `(voxels, labels)`: voxels (B, 1, D, H, W)
    float32, augmented and preprocessed on `device`; labels a host int32
    array (nothing on the device reads them).

    - static shapes: the trailing partial batch is dropped;
    - seeded per-epoch shuffling, `np.random.RandomState(seed + epoch)`, so
      the order is the JAX pipeline's bit for bit;
    - `augment(generator, raw)` runs on the device before preprocessing
      (reference data_load.py:21-23), with a generator on the device seeded
      with `seed * 100003 + epoch * steps_per_epoch + step`, as the JAX key
      (the same on every rank: the augmentations draw their batch-axis
      parameters for the global batch and keep this rank's rows);
    - under data parallelism each rank yields its rows of every global
      batch of `batch_size` (`steps_per_epoch` counts global batches);
    - a background thread prefetches `PREFETCH` batches ahead.

    On a CUDA device the thread fills one of `PREFETCH` pinned host buffers (it
    waits for that buffer's previous copy to finish before it writes it
    again), copies it with `non_blocking` on a side stream, runs the device
    work there and records an event; the consumer's stream waits on that
    event, and the batch is `record_stream`ed to it, so the allocator does
    not reuse its memory while the consumer's work may still read it.
    """

    def __init__(
        self,
        source: BrainDataSource,
        batch_size: int,
        device: Optional[Union[str, torch.device]] = None,
        shuffle: bool = True,
        seed: int = 103,           # seed_ti in the entry scripts (main.py:51)
        augment: Optional[Augment] = None,
    ):
        self.source = source
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.augment = augment
        self.rows = local_batch_slice(batch_size)   # this rank's rows of a batch
        self.steps_per_epoch = len(source) // batch_size
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"dataset of {len(source)} volumes < batch size {batch_size}")

    def _device_batch(self, host: torch.Tensor, epoch_idx: int, step: int) -> torch.Tensor:
        vox = host.to(self.device, non_blocking=True)
        if self.augment is not None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.seed * 100003 + epoch_idx * self.steps_per_epoch + step)
            vox = self.augment(gen, vox)
        return preprocess_batch(vox)

    def epoch(self, epoch_idx: int) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
        order = np.arange(len(self.source))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch_idx).shuffle(order)
        cuda = self.device.type == "cuda"
        stop = threading.Event()

        def _put(q: queue.Queue, item) -> bool:
            # Bounded-queue put that aborts when the consumer is gone, so an
            # abandoned generator cannot strand the producer on a full queue.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def produce(q: queue.Queue):
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                    stream = torch.cuda.Stream(self.device)
                    shape = (self.rows.stop - self.rows.start,) + self.source.voxels.shape[1:]
                    pinned = [torch.empty(shape, dtype=torch.float32, pin_memory=True)
                              for _ in range(PREFETCH)]
                    copied = [None] * PREFETCH
                for step in range(self.steps_per_epoch):
                    if stop.is_set():
                        return
                    idx = order[step * self.batch_size:(step + 1) * self.batch_size][self.rows]
                    lab = self.source.labels[idx]
                    if not cuda:
                        vox = self._device_batch(torch.from_numpy(self.source.voxels[idx]),
                                                 epoch_idx, step)
                        if not _put(q, (vox, lab, None)):
                            return
                        continue
                    k = step % PREFETCH
                    if copied[k] is not None:
                        copied[k].synchronize()  # its last copy has left the buffer
                    np.take(self.source.voxels, idx, axis=0, out=pinned[k].numpy())
                    with torch.cuda.stream(stream):
                        vox = self._device_batch(pinned[k], epoch_idx, step)
                        copied[k] = torch.cuda.Event()
                        copied[k].record(stream)
                        # the copy precedes the device work on this stream,
                        # so one event marks both the copy and the batch done
                    if not _put(q, (vox, lab, copied[k])):
                        return
                _put(q, None)
            except Exception as e:  # surface worker errors to the consumer
                _put(q, e)

        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                vox, lab, ready = item
                if ready is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(ready)
                    vox.record_stream(consumer)
                yield vox, lab
        finally:
            # Runs on normal exhaustion AND on generator close/GC (the
            # trainer's panels take only the first batch). Unblock a
            # producer mid-put, then join so no thread outlives the epoch.
            stop.set()
            for _ in range(3):
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
                t.join(timeout=5.0)
                if not t.is_alive():
                    break
            else:
                warnings.warn("DataPipeline producer thread did not exit within 15s of "
                              "epoch teardown; it may still be running", stacklevel=2)

    def first_batch(self) -> Tuple[torch.Tensor, np.ndarray]:
        """One batch from epoch 0, with the prefetch thread cleaned up
        (the trainer's panels)."""
        gen = self.epoch(0)
        try:
            return next(gen)
        finally:
            gen.close()
