"""The port's packed input cache (``data/packed.py``) and oversize
transforms against the JAX package's: caches packed by the JAX
``pack_split`` read item for item bit for bit (eval, the host random
suffix on the same numpy generator, and ``device_augment``), the port's
``pack_split`` writes the same bytes, the stale guard fires on the same
edits, and the cache ``chip_smoke.py`` writes with numpy alone reads the
same through both packages. Every comparison is exact.
"""

import importlib.util
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from multimodal_plankton_recognition_tpu.data.packed import (
    PackedMultiSet as JaxPackedMultiSet, pack_split as jax_pack_split,
)
from multimodal_plankton_recognition_tpu.data.synthetic import (
    make_synthetic_dataset,
)
from multimodal_plankton_recognition_tpu.data import (
    transforms as jax_transforms,
)
from multimodal_plankton_recognition_torch.data import transforms
from multimodal_plankton_recognition_torch.data.packed import (
    PackedMultiSet, cache_dir, pack_split,
)
from multimodal_plankton_recognition_torch.data.profile_io import (
    load_image, load_profile_csv,
)

REPO = Path(__file__).resolve().parent.parent
TS = 32
FILES = ("images", "profiles", "shapes", "lens", "labels")


def _dataset(root: Path) -> Path:
    """The synthetic dataset with its annotations as both split CSVs,
    packed by the JAX package."""
    make_synthetic_dataset(root, n_classes=3, n_per_class=6, seed=11,
                           with_split=False)
    ann = (root / "annotations.csv").read_text()
    for split in ("train", "test"):
        (root / f"{split}.csv").write_text(ann)
        jax_pack_split(root / f"{split}.csv", TS)
    return root


@pytest.fixture(scope="module")
def packed_root(tmp_path_factory):
    return _dataset(tmp_path_factory.mktemp("packed") / "data")


def _same_items(a, b):
    assert a.keys() == b.keys()
    for k in a:
        av, bv = np.asarray(a[k]), np.asarray(b[k])
        assert av.dtype == bv.dtype and av.shape == bv.shape, k
        np.testing.assert_array_equal(av, bv, err_msg=k)


@pytest.mark.parametrize("split", ["train", "test"])
def test_pack_split_writes_the_jax_bytes(packed_root, tmp_path, split):
    csv = packed_root / f"{split}.csv"
    out = pack_split(csv, TS, out_dir=tmp_path / split)
    want = cache_dir(csv, TS)
    for name in FILES:
        assert (out / f"{name}.npy").read_bytes() == \
            (want / f"{name}.npy").read_bytes(), name
    assert json.loads((out / "meta.json").read_text()) == \
        json.loads((want / "meta.json").read_text())


@pytest.mark.parametrize("mode", ["eval", "host suffix", "device_augment"])
def test_items_match_jax(packed_root, mode):
    """Every item, on the same numpy generator: the test split's eval
    output, the train split's host random suffix, and its stored oversize
    prefix under ``device_augment``."""
    split = "test" if mode == "eval" else "train"
    augment = mode == "device_augment"
    csv = packed_root / f"{split}.csv"
    port = PackedMultiSet(csv, TS, device_augment=augment)
    ref = JaxPackedMultiSet(csv, TS, device_augment=augment)
    assert len(port) == len(ref) == 18
    np.testing.assert_array_equal(port.class_names, ref.class_names)
    np.testing.assert_array_equal(port.labels, ref.labels)
    side = TS if split == "test" else port.oversize
    assert port.images.shape == (18, side, side)
    for i in range(len(port)):
        _same_items(port.__getitem__(i, np.random.default_rng(1000 + i)),
                    ref.__getitem__(i, np.random.default_rng(1000 + i)))
    if mode == "host suffix":
        assert port[0]["image"].shape == (TS, TS, 1)
        assert port[0]["profile"].shape[0] == TS


def _touch(path: Path):
    st = path.stat()
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))


def _add_row(path: Path):
    """One more data row, the file's mtime put back: only the row count
    differs."""
    st = path.stat()
    lines = path.read_text().splitlines()
    path.write_text("\n".join(lines + [lines[-1]]) + "\n")
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))


def _rewrite_payload(path: Path):
    """The first row's image rewritten, the CSV untouched."""
    image = path.parent / path.read_text().splitlines()[1].split(",")[0]
    image.write_bytes(image.read_bytes() + b"\x00")


@pytest.mark.parametrize("edit,match", [
    (_touch, "source csv changed"), (_add_row, "source csv changed"),
    (_rewrite_payload, "payload")], ids=["mtime", "rows", "payload"])
def test_stale_guard_fires_on_the_jax_edits(tmp_path, edit, match):
    root = _dataset(tmp_path / "data")
    csv = root / "train.csv"
    PackedMultiSet(csv, TS)
    edit(csv)
    with pytest.raises(RuntimeError, match=match):
        JaxPackedMultiSet(csv, TS)
    with pytest.raises(RuntimeError, match=match):
        PackedMultiSet(csv, TS)


def test_missing_cache_and_empty_split(tmp_path):
    csv = tmp_path / "train.csv"
    csv.write_text("image,profile,class\n")
    with pytest.raises(FileNotFoundError, match="no packed cache"):
        PackedMultiSet(csv, TS)
    with pytest.raises(ValueError, match="no data rows"):
        pack_split(csv, TS)


def test_oversize_transforms_match_jax(packed_root):
    rows = [line.split(",") for line in
            (packed_root / "train.csv").read_text().splitlines()[1:4]]
    for image, profile, _ in rows:
        img = load_image(packed_root / image)
        prof = load_profile_csv(packed_root / profile)
        for port_tf, jax_tf, x in (
                (transforms.ImageTransformOversize,
                 jax_transforms.ImageTransformOversize, img),
                (transforms.ProfileTransformOversize,
                 jax_transforms.ProfileTransformOversize, prof)):
            got, want = port_tf(TS)(x), jax_tf(TS)(x)
            assert got.dtype == want.dtype == np.float32
            assert got.shape[0] == 34
            np.testing.assert_array_equal(got, want)


def test_chip_smoke_writer_reads_the_same_through_both(tmp_path):
    """``chip_smoke.write_packed_splits`` (numpy, json and csv alone) writes
    a cache that both packages read, item for item the same, with its
    stale guard armed."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    root = smoke.write_packed_splits(tmp_path / "data", TS, 12, 8, 3, seed=5)
    for split, n, side in (("train", 12, 34), ("test", 8, TS)):
        csv = root / f"{split}.csv"
        for augment in (False, True):
            port = PackedMultiSet(csv, TS, device_augment=augment)
            ref = JaxPackedMultiSet(csv, TS, device_augment=augment)
            assert len(port) == len(ref) == n
            assert port.images.shape == (n, side, side)
            assert port.profiles.shape == (n, side, 6)
            np.testing.assert_array_equal(port.class_names, ref.class_names)
            assert len(port.class_names) == 3
            for i in range(n):
                _same_items(port.__getitem__(i, np.random.default_rng(i)),
                            ref.__getitem__(i, np.random.default_rng(i)))
    copy = tmp_path / "copy"
    shutil.copytree(root, copy)
    _rewrite_payload(copy / "test.csv")
    with pytest.raises(RuntimeError, match="payload"):
        PackedMultiSet(copy / "test.csv", TS)
