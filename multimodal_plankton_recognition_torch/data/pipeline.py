"""Host input pipeline (``data/pipeline.py`` of the JAX package): a
deterministic threaded batch loader, the contrastive collate, and the
copy of host batches to the card (JAX's ``prefetch_to_device``).

Samples load on worker threads (PIL releases the GIL while it decodes);
each sample's random generator comes from (seed, epoch, index), so a run
repeats whatever the scheduling. For the card, ``PinnedCollate`` pins each
batch on the loader's producer thread, and ``device_put`` copies it with
``non_blocking=True``: the host queues the copy and the step that reads
it without waiting, so while the card runs one step the next batch is
already queued behind it. The supervised classifiers' collates
(``ImageCollate``, ``ProfileCollate``) give their integer ``label`` ids.
With ``host_shard=(index, count)`` each rank of a process group loads only
its contiguous slice of every identically shuffled global batch (JAX's
multi-host loader; a "host" is a rank here).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


class Loader:
    """Batches of ``collate_fn([dataset[i], ...])`` in order (or shuffled
    per epoch from ``seed``), ``prefetch_batches`` ahead of the consumer."""

    def __init__(self, dataset, batch_size: int, collate_fn: Callable,
                 shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 4, seed: int = 0,
                 prefetch_batches: int = 2,
                 host_shard: Optional[Tuple[int, int]] = None,
                 split_tail: bool = False) -> None:
        """``batch_size`` is the global batch. ``host_shard=(index,
        count)`` yields only slice ``index`` of ``count`` equal contiguous
        slices of each batch; a trailing partial batch gives each rank
        ``rows // count`` rows and drops the rest, none when that is 0 (as
        JAX). ``split_tail`` instead splits that batch as
        ``numpy.array_split`` does, so that every row is some rank's (an
        empty slice yields ``{}``)."""
        if host_shard is not None and batch_size % host_shard[1]:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{host_shard[1]} host processes")
        self.host_shard = host_shard
        self.split_tail = split_tail
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, 0xD5]))
            rng.shuffle(order)
        if self.drop_last:
            order = order[: (len(order) // self.batch_size) * self.batch_size]
        return order

    def _shard(self, idx: np.ndarray) -> Optional[np.ndarray]:
        """This rank's indices of one batch's ``idx``; None where JAX's
        loader skips the batch."""
        if self.host_shard is None:
            return idx
        p, n = self.host_shard
        if self.split_tail and len(idx) < self.batch_size:
            return np.array_split(idx, n)[p]
        local = len(idx) // n
        if local == 0:  # a partial batch smaller than the hosts: skipped
            return None
        return idx[p * local:(p + 1) * local]

    def _load_sample(self, epoch: int, index: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, int(index)]))
        return self.dataset.__getitem__(int(index), rng)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = self.epoch
        self.epoch += 1
        order = self._epoch_order(epoch)
        starts = range(0, len(order), self.batch_size)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def put(item) -> bool:
            """A bounded put that gives up once the consumer has gone."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for s in starts:
                        idx = self._shard(order[s:s + self.batch_size])
                        if idx is None:
                            continue
                        if not len(idx):
                            if not put({}):
                                return
                            continue
                        samples = list(pool.map(
                            lambda i: self._load_sample(epoch, i), idx))
                        if not put(self.collate_fn(samples)):
                            return
                put(None)
            except BaseException as e:  # re-raised in the consumer
                put(e)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


class MultiCollate:
    """Contrastive-pretraining collate: stacked images, the tokenized
    profiles, ``image_shape`` and ``profile_len``; with ``vocab``, integer
    ``label`` ids (for ArcFace)."""

    def __init__(self, tokenizer: Callable, vocab=None) -> None:
        self.tokenizer = tokenizer
        self.vocab = vocab

    def __call__(self, samples) -> Dict[str, np.ndarray]:
        batch = {"image": np.stack([s["image"] for s in samples])}
        batch.update(self.tokenizer([s["profile"] for s in samples]))
        batch["image_shape"] = np.stack([s["image_shape"] for s in samples])
        batch["profile_len"] = np.stack([s["profile_length"]
                                         for s in samples])
        if self.vocab is not None:
            batch["label"] = self.vocab.transform(
                [s["label"] for s in samples])
        return batch


class ImageCollate:
    """Supervised image-classifier collate: stacked images, ``label`` ids
    from ``vocab`` and ``image_shape``."""

    def __init__(self, vocab) -> None:
        self.vocab = vocab

    def __call__(self, samples) -> Dict[str, np.ndarray]:
        return {
            "image": np.stack([s["image"] for s in samples]),
            "label": self.vocab.transform([s["label"] for s in samples]),
            "image_shape": np.stack([s["image_shape"] for s in samples]),
        }


class ProfileCollate:
    """Supervised profile-classifier collate: the tokenized profiles,
    ``label`` ids from ``vocab`` and ``profile_len``."""

    def __init__(self, tokenizer: Callable, vocab) -> None:
        self.tokenizer = tokenizer
        self.vocab = vocab

    def __call__(self, samples) -> Dict[str, np.ndarray]:
        batch = dict(self.tokenizer([s["profile"] for s in samples]))
        batch["label"] = self.vocab.transform([s["label"] for s in samples])
        batch["profile_len"] = np.stack(
            [s["profile_length"] for s in samples])
        return batch


def multi_collate_fn(tokenizer: Callable, vocab=None) -> Callable:
    return MultiCollate(tokenizer, vocab)


def image_collate_fn(vocab) -> Callable:
    return ImageCollate(vocab)


def profile_collate_fn(tokenizer: Callable, vocab) -> Callable:
    return ProfileCollate(tokenizer, vocab)


class PinnedCollate:
    """``collate_fn``'s batch as CPU tensors in page-locked memory, made
    on the thread that collates (the loader's producer), so the card's
    copy of it can run without a host wait."""

    def __init__(self, collate_fn: Callable) -> None:
        self.collate_fn = collate_fn

    def __call__(self, samples) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in self.collate_fn(samples).items()}


def device_put(device: torch.device | str) -> Callable:
    """A ``Fitter`` ``put_fn`` that places a batch on ``device``: on the
    CPU ``torch.as_tensor`` of each array; on a card a non-blocking copy
    of each (pinned, ``PinnedCollate``) tensor."""
    device = torch.device(device)
    if device.type == "cpu":
        return lambda batch: {k: torch.as_tensor(v)
                              for k, v in batch.items()}
    return lambda batch: {k: torch.as_tensor(v).to(device, non_blocking=True)
                          for k, v in batch.items()}
