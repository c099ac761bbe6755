"""The port's process-based loader (``data/grain_pipeline.py``) against
its threaded ``Loader`` and the JAX package's ``GrainLoader``, and
``loader: grain`` through the train driver.

Every comparison is exact: the same (seed, epoch) shuffles and
per-sample generators give the same bits, whatever runs the transforms
(threads, worker processes, or the JAX package's grain loader in its
process).
"""

import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.data import tokenize as jax_tok
from multimodal_plankton_recognition_tpu.data.dataset import (
    MultiSet as JaxMultiSet,
)
from multimodal_plankton_recognition_tpu.data.grain_pipeline import (
    GrainLoader as JaxGrainLoader,
)
from multimodal_plankton_recognition_tpu.data.pipeline import (
    multi_collate_fn as jax_collate,
)
from multimodal_plankton_recognition_tpu.data.transforms import (
    ImageTransformTrain as JaxImageTrain, PairAugmentation as JaxPairAug,
    ProfileTransformTrain as JaxProfileTrain,
)
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.data.dataset import MultiSet
from multimodal_plankton_recognition_torch.data.grain_pipeline import (
    GrainLoader,
)
from multimodal_plankton_recognition_torch.data.packed import (
    PackedMultiSet, pack_split,
)
from multimodal_plankton_recognition_torch.data.pipeline import (
    Loader, multi_collate_fn,
)
from multimodal_plankton_recognition_torch.data.synthetic import (
    make_synthetic_dataset,
)
from multimodal_plankton_recognition_torch.data.tokenize import get_tokenizer
from multimodal_plankton_recognition_torch.data.transforms import (
    ImageTransformTrain, PairAugmentation, ProfileTransformTrain,
)
from multimodal_plankton_recognition_torch.train import drivers
from torch_threads import single_thread

TS = 32


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = make_synthetic_dataset(tmp_path_factory.mktemp("grain_data"),
                                  n_classes=3, n_per_class=8, seed=4)
    for name in ("train", "test"):
        pack_split(root / f"{name}.csv", TS)
    return root


def _csv_set(split):
    return MultiSet(split / "train.csv", ImageTransformTrain(TS),
                    ProfileTransformTrain(TS), PairAugmentation())


def _collate():
    return multi_collate_fn(get_tokenizer("cnn", TS, pad_to=TS))


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("workers", [0, 2])
def test_batches_equal_loader_and_jax(split, workers):
    """Two epochs over the CSV path's random train transforms: the port's
    ``GrainLoader`` (in-process, or two worker processes) against the
    port's ``Loader`` and JAX's ``GrainLoader`` (in-process)."""
    ds = _csv_set(split)
    port = GrainLoader(ds, 4, _collate(), shuffle=True, drop_last=True,
                       num_workers=workers, seed=11)
    threads = Loader(ds, 4, _collate(), shuffle=True, drop_last=True,
                     num_workers=2, seed=11)
    jds = JaxMultiSet(split / "train.csv", JaxImageTrain(TS),
                      JaxProfileTrain(TS), JaxPairAug())
    jax_loader = JaxGrainLoader(
        jds, 4, jax_collate(jax_tok.get_tokenizer("cnn", TS, pad_to=TS)),
        shuffle=True, drop_last=True, num_workers=0, seed=11)
    n = 0
    for _ in range(2):
        for a, b, c in zip(port, threads, jax_loader):
            _same(a, b)
            _same(a, c)
            n += 1
    assert n == 2 * len(port) == 2 * (len(ds) // 4)
    assert port.epoch == 2
    port.close()


def test_process_workers_over_packed_pairs(split):
    """Two worker processes over the packed cache (the dataset pickles its
    paths and re-opens the memmaps in each worker) against the threaded
    ``Loader`` over the same packed set, and the pinned mode's tensors."""
    packed = PackedMultiSet(split / "train.csv", TS)
    import pickle
    assert len(pickle.dumps(packed)) < 4096
    port = GrainLoader(packed, 4, _collate(), shuffle=True, drop_last=True,
                       num_workers=2, seed=21)
    threads = Loader(packed, 4, _collate(), shuffle=True, drop_last=True,
                     num_workers=2, seed=21)
    n = 0
    for a, b in zip(port, threads):
        _same(a, b)
        n += 1
    assert n == len(port) > 0
    port.close()
    tensors = GrainLoader(packed, 4, _collate(), shuffle=True,
                          drop_last=True, num_workers=0, seed=21)
    tensors.pin_memory = False
    for a, b in zip(tensors, Loader(packed, 4, _collate(), shuffle=True,
                                    drop_last=True, seed=21)):
        _same(a, b)


@pytest.mark.parametrize("drop_last", [True, False])
def test_host_shard(split, drop_last):
    """Each rank's slice of every batch, concatenated, is the global
    batch; a trailing partial batch splits as ``Loader``'s does, and the
    port matches JAX's host-shard mode."""
    ds = _csv_set(split)
    full = list(Loader(ds, 6, _collate(), shuffle=True,
                       drop_last=drop_last, seed=3))
    shards = [list(GrainLoader(ds, 6, _collate(), shuffle=True,
                               drop_last=drop_last, num_workers=0, seed=3,
                               host_shard=(p, 2))) for p in range(2)]
    assert len(shards[0]) == len(shards[1])
    for bf, b0, b1 in zip(full, *shards):
        np.testing.assert_array_equal(
            np.concatenate([b0["image"], b1["image"]]),
            bf["image"][:len(b0["image"]) * 2])
    jds = JaxMultiSet(split / "train.csv", JaxImageTrain(TS),
                      JaxProfileTrain(TS), JaxPairAug())
    jcollate = jax_collate(jax_tok.get_tokenizer("cnn", TS, pad_to=TS))
    for p in range(2):
        jax_loader = JaxGrainLoader(jds, 6, jcollate, shuffle=True,
                                    drop_last=drop_last, num_workers=0,
                                    seed=3, host_shard=(p, 2))
        got = list(zip(shards[p], jax_loader))
        assert len(got) == len(shards[p])
        for a, b in got:
            _same(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        GrainLoader(ds, 5, _collate(), host_shard=(0, 2))


def test_split_tail(split):
    ds = _csv_set(split)
    kwargs = dict(shuffle=False, drop_last=False, seed=1, split_tail=True)
    for p in range(2):
        want = list(Loader(ds, 10, _collate(), host_shard=(p, 2),
                           num_workers=1, **kwargs))
        got = list(GrainLoader(ds, 10, _collate(), host_shard=(p, 2),
                               num_workers=0, **kwargs))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)


def test_early_break_realigns(split):
    """An epoch left after one batch replays from its start; the next
    epoch follows the (seed, epoch) schedule (JAX's test)."""
    ds = _csv_set(split)
    ref = GrainLoader(ds, 4, _collate(), shuffle=True, drop_last=True,
                      num_workers=0, seed=11)
    golden = [[b["image"] for b in ref] for _ in range(2)]
    loader = GrainLoader(ds, 4, _collate(), shuffle=True, drop_last=True,
                         num_workers=2, seed=11)
    for b in loader:
        first = b["image"]
        break
    np.testing.assert_array_equal(first, golden[0][0])
    for got, want in zip(loader, golden[0]):
        np.testing.assert_array_equal(got["image"], want)
    for got, want in zip(loader, golden[1]):
        np.testing.assert_array_equal(got["image"], want)
    assert loader.epoch == 2
    loader.close()
    for got, want in zip(loader, golden[0][:1]):  # epoch 2, new workers
        assert got["image"].shape == want.shape
    loader.close()


def test_train_multi_history_is_the_threads_history(split, tmp_path):
    """``loader: grain`` (two worker processes) and ``loader: threads``
    give ``train_multi`` the same batches: the same history, losses bit
    for bit, over 2 epochs of the packed split."""
    from test_torch_drivers import _card

    histories = []
    for loader in ("grain", "threads"):
        d = _card(packed_cache=True, loader=loader, num_workers=2)
        with single_thread():
            out = drivers.train_multi(split, config.ModelCard.from_dict(d),
                                      logdir=tmp_path / loader, max_epochs=2,
                                      device="cpu")
        histories.append([{k: v for k, v in h.items()
                           if k != "samples_per_sec"}
                          for h in out["history"]])
    assert len(histories[0]) == 2
    assert histories[0] == histories[1]


def test_pin_memory_stays_in_the_parent(split, monkeypatch):
    """The workers return CPU tensors; ``pin_memory`` asks the parent's
    ``DataLoader`` to pin them (here on the CPU, the flag is only passed
    on)."""
    seen = {}
    real = torch.utils.data.DataLoader.__init__

    def spy(self, *args, **kwargs):
        seen.update(kwargs)
        real(self, *args, **dict(kwargs, pin_memory=False))

    monkeypatch.setattr(torch.utils.data.DataLoader, "__init__", spy)
    loader = GrainLoader(PackedMultiSet(split / "train.csv", TS), 4,
                         _collate(), num_workers=0, pin_memory=True)
    batch = next(iter(loader))
    assert seen["pin_memory"] is True
    assert isinstance(batch["image"], torch.Tensor)
