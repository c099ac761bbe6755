"""Host input pipeline (``data/pipeline.py`` of the JAX package): a
deterministic threaded batch loader and the contrastive collate.

Samples load on worker threads (PIL releases the GIL while it decodes);
each sample's random generator comes from (seed, epoch, index), so a run
repeats whatever the scheduling. Not ported: the multi-host sharding of
the loader and the supervised collates.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator

import numpy as np


class Loader:
    """Batches of ``collate_fn([dataset[i], ...])`` in order (or shuffled
    per epoch from ``seed``), ``prefetch_batches`` ahead of the consumer."""

    def __init__(self, dataset, batch_size: int, collate_fn: Callable,
                 shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 4, seed: int = 0,
                 prefetch_batches: int = 2) -> None:
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
                        idx = order[s:s + self.batch_size]
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


def multi_collate_fn(tokenizer: Callable, vocab=None) -> Callable:
    return MultiCollate(tokenizer, vocab)
