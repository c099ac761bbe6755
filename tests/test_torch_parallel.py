"""The parallel layer's pieces on two gloo ranks against the JAX package's
on a 2-device CPU mesh (``jax.devices()[:2]`` of the 8 that
``tests/conftest.py`` fakes):

* the global CLIP and SigLIP losses: each rank's unreduced loss and its
  gradients against JAX's ``make_global_loss_shard_map`` and its
  ``jax.grad``, and against the port's one-process loss with
  ``buckets=1``. A rank's gradient of its own loss, summed over the
  ranks through the all-gather's backward, is the ranks' count times
  the global loss's gradient of its rows;
* the row-sharded kNN against JAX's ``sharded_topk_euclidean`` on
  tie-free data (an even and an uneven gallery), ``k`` above the real
  rows, ``ANNClassifier(sharded=True)`` and ``run_suite(sharded=True)``
  against the default;
* the mesh's own collectives: ``shard_batch``, ``replicate_state``,
  ``gather_uneven``, ``make_global_batch``;
* ``Loader(host_shard=...)`` rows against JAX's, the trailing batch
  included, and ``split_tail``;
* a process group of one rank: its mesh step is ``make_multi_steps``'
  bit for bit.

Tolerances: f32 losses to 1e-5 relative, f32 gradients to 1e-4 relative
L2; kNN indices equal, distances within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from multimodal_plankton_recognition_tpu.data.pipeline import (
    Loader as JaxLoader,
)
from multimodal_plankton_recognition_tpu.parallel import (
    create_mesh as jax_create_mesh,
    global_clip_loss as jax_global_clip_loss,
    global_siglip_loss as jax_global_siglip_loss,
)
from multimodal_plankton_recognition_tpu.parallel.contrastive import (
    make_global_loss_shard_map,
)
from multimodal_plankton_recognition_tpu.parallel.knn import (
    sharded_topk_euclidean as jax_sharded_topk,
)
from multimodal_plankton_recognition_torch.config import OptimConfig
from multimodal_plankton_recognition_torch.data.pipeline import Loader
from multimodal_plankton_recognition_torch.models.multi import MultiModel
from multimodal_plankton_recognition_torch.ops import losses
from multimodal_plankton_recognition_torch.ops.knn import ANNClassifier
from multimodal_plankton_recognition_torch.parallel.mesh import create_mesh
from multimodal_plankton_recognition_torch.retrieval import benchmark
from multimodal_plankton_recognition_torch.train import (
    create_train_state, make_multi_steps, make_optimizer,
)
from test_torch_parallel_steps import _batch, _model_args
from torch_ranks import Ranks
from torch_threads import one_thread  # noqa: F401

LOSS_TOL, GRAD_TOL, DIST_TOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = Ranks(2, tmp_path_factory.mktemp("parallel"))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_create_mesh(n_data=2, devices=jax.devices()[:2])


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# --- the global losses -----------------------------------------------------

@pytest.mark.parametrize("method", ["clip", "siglip"])
def test_global_losses_match_jax(method, ranks, jax_mesh):
    rs = np.random.RandomState(1)
    image = rs.randn(8, 12).astype(np.float32)
    profile = rs.randn(8, 12).astype(np.float32)
    scale, bias = 0.7, -3.0
    got = ranks.run("global_loss", method, image, profile, scale, bias)

    if method == "clip":
        fn = make_global_loss_shard_map(jax_global_clip_loss, jax_mesh,
                                        n_scalars=1)
        args = (jnp.asarray(image), jnp.asarray(profile), jnp.asarray(scale))
    else:
        fn = make_global_loss_shard_map(jax_global_siglip_loss, jax_mesh,
                                        n_scalars=2)
        args = (jnp.asarray(image), jnp.asarray(profile), jnp.asarray(scale),
                jnp.asarray(bias))
    want, grads = jax.value_and_grad(fn, argnums=tuple(range(len(args))))(
        *args)
    want = float(want)

    # the port's one-process loss of the global batch, one bucket
    t = [torch.tensor(a, requires_grad=True)
         for a in (image, profile, scale, bias)]
    one = losses.clip_loss(t[0], t[1], t[2], 1) if method == "clip" \
        else losses.siglip_loss(*t, 1)
    one.backward()

    n = len(got)
    for value in (np.mean([r["local"] for r in got]), float(one),
                  *(r["reduced"] for r in got)):
        assert abs(value - want) <= LOSS_TOL * abs(want)
    # rank r's gradient of its own loss is n x the global gradient of its
    # rows; the scalars' global gradient is the ranks' mean
    for key, jgrad, tgrad in (("i", grads[0], t[0]), ("p", grads[1], t[1])):
        rows = np.concatenate([r[key] for r in got]) / n
        assert _rel_l2(rows, jgrad) <= GRAD_TOL, key
        assert _rel_l2(tgrad.grad, jgrad) <= GRAD_TOL, key
    scalars = [("scale", grads[2], t[2])]
    if method == "siglip":
        scalars.append(("bias", grads[3], t[3]))
    for key, jgrad, tgrad in scalars:
        mean = np.mean([r[key] for r in got])
        assert abs(mean - float(jgrad)) <= GRAD_TOL * abs(float(jgrad)), key
        assert abs(float(tgrad.grad) - float(jgrad)) <= GRAD_TOL * abs(
            float(jgrad)), key


# --- the sharded kNN -------------------------------------------------------

def _knn_data(n_gallery, n_query=13, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_gallery, dim)).astype(np.float32),
            rng.normal(size=(n_query, dim)).astype(np.float32))


@pytest.mark.parametrize("n_gallery,k", [(40, 5), (41, 25)],
                         ids=["even", "uneven-padded"])
def test_sharded_knn_matches_jax(n_gallery, k, ranks, jax_mesh):
    """k = 5 merges candidates below the shard's rows; k = 25 above a
    rank's 21 rows takes all of them (the pad row of the uneven gallery
    must never be a neighbour)."""
    gallery, queries = _knn_data(n_gallery)
    want_idx, want_dist = jax_sharded_topk(queries, gallery, k=k,
                                           mesh=jax_mesh)
    got = ranks.run("sharded_knn", gallery, queries, k)
    shard = -(-n_gallery // 2)
    for rank in got:
        assert rank["shard"] == (shard, 16)
        np.testing.assert_array_equal(rank["idx"], want_idx)
        np.testing.assert_allclose(rank["dist"], want_dist, atol=DIST_TOL)
    assert got[0]["idx"].max() < n_gallery


def test_sharded_knn_k_above_the_real_rows_raises(ranks):
    gallery, queries = _knn_data(41)
    for rank in ranks.run("sharded_knn", gallery, queries, 42):
        assert rank["error"] == "k=42 exceeds gallery size 41"


def test_sharded_ann_classifier_predicts_as_the_default(ranks):
    gallery, queries = _knn_data(41, seed=2)
    labels = np.arange(41) % 5
    queries2 = _knn_data(41, seed=3)[1]
    ks = (1, 3, 9)
    want = ANNClassifier(gallery, labels, "cpu").predict_many(
        queries, queries2, ks=ks)
    for rank in ranks.run("knn_predict", gallery, labels,
                          (queries, queries2), ks):
        for k in ks:
            np.testing.assert_array_equal(rank[k], want[k])


def test_run_suite_sharded_equals_the_default(ranks):
    rs = np.random.RandomState(0)
    names = np.repeat(np.array(["a", "b", "c"]), [30, 24, 27])
    rs.shuffle(names)
    emb = {"m": {1: {"image": rs.randn(81, 8).astype(np.float32),
                     "profile": rs.randn(81, 8).astype(np.float32),
                     "label": names, "classes": np.array(["a", "b", "c"])}}}
    for mode in ("raw", "cross"):
        want = benchmark.run_suite(emb, mode, (4, 8), (1, 3), 2, th=10,
                                   device="cpu")
        for got in ranks.run("suite", emb, mode, (4, 8), (1, 3), 2, 10,
                             True):
            _assert_same(got, want, mode)


def _assert_same(got, want, path):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for key in want:
            _assert_same(got[key], want[key], f"{path}[{key!r}]")
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


# --- the mesh's collectives ------------------------------------------------

def test_mesh_collectives(ranks):
    got = ranks.run("mesh_collectives")
    for rank, out in enumerate(got):
        assert out["mesh"] == {"n_data": 2, "n_model": 1, "rank": rank,
                               "data_index": rank}
        np.testing.assert_array_equal(out["shard"],
                                      np.arange(12).reshape(6, 2)[
                                          3 * rank:3 * rank + 3])
        # rank 0's state everywhere: step, masters, momentum, statistics
        assert out["step"] == 7
        for key in ("master", "momentum", "stat"):
            np.testing.assert_array_equal(out[key], got[0][key])
        # rank 0 holds 3 rows, rank 1 none: gathered in rank order
        np.testing.assert_array_equal(out["uneven"], [0, 1, 2])
        assert out["global_rows"] == 4
        assert "every" not in out["mismatch"] and "rows" in out["mismatch"]


def test_classifier_eval_over_uneven_shares(ranks):
    """The classifier's eval step where the ranks hold 2 + 1 rows and 1 +
    none (a split trailing batch): the loss of every row, and every row's
    prediction and label in order, as one process over the same rows."""
    from multimodal_plankton_recognition_torch.models.classifier import (
        ImageClassifier,
    )
    from multimodal_plankton_recognition_torch.train import (
        make_classifier_steps,
    )

    image_args = _model_args()["image_encoder_args"]
    model = ImageClassifier(n_classes=3, image_encoder_args=image_args,
                            dtype=torch.float32)
    init = {k: v.numpy() for k, v in model.state_dict().items()}
    full = {k: v[:3] for k, v in _batch().items()
            if k in ("image", "image_shape")}
    full["label"] = np.array([2, 0, 1])
    tx = make_optimizer(OptimConfig())
    state = create_train_state(model, {k: torch.as_tensor(v)
                                       for k, v in init.items()}, tx)
    _, eval_step = make_classifier_steps(model, tx)
    for split in ((2, 1), (1, 0)):
        rows = sum(split)
        want = eval_step(state, {k: torch.as_tensor(v[:rows])
                                 for k, v in full.items()})
        for got in ranks.run("classifier_eval", image_args, init, full,
                             split):
            assert abs(got["loss"] - float(want["loss"])) <= LOSS_TOL * abs(
                float(want["loss"]))
            np.testing.assert_array_equal(got["pred"], want["pred"])
            np.testing.assert_array_equal(got["label"], full["label"][:rows])


# --- the loader -------------------------------------------------------------

class _Rows:
    """Row ``i`` is ``{"i": i, "draw": a draw of its generator}``."""

    def __len__(self):
        return 23

    def __getitem__(self, i, rng):
        return {"i": i, "draw": rng.random()}


def _collate(samples):
    return {"i": np.array([s["i"] for s in samples]),
            "draw": np.array([s["draw"] for s in samples])}


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_host_shard_rows_match_jax(drop_last, shuffle):
    """23 rows in global batches of 6 over 2 ranks: 3 rows a rank a batch;
    the trailing 5 rows give each rank 2 and drop one, as JAX's loader
    does, unless ``drop_last``; two epochs."""
    for p in range(2):
        kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=2,
                  seed=5, host_shard=(p, 2))
        port = Loader(_Rows(), 6, _collate, **kw)
        ref = JaxLoader(_Rows(), 6, _collate, **kw)
        for _ in range(2):
            got, want = list(port), list(ref)
            assert len(got) == len(want) == (3 if drop_last else 4)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g["i"], w["i"])
                np.testing.assert_array_equal(g["draw"], w["draw"])


def test_split_tail_covers_every_row():
    """``split_tail``: the trailing batch's 5 rows as 3 + 2; every row of
    the epoch on exactly one rank; a rank whose share is empty gets {}."""
    seen = []
    for p in range(2):
        batches = list(Loader(_Rows(), 6, _collate, num_workers=2,
                              host_shard=(p, 2), split_tail=True))
        assert [len(b["i"]) for b in batches] == [3, 3, 3, 3 - p]
        seen += [i for b in batches for i in b["i"]]
    assert sorted(seen) == list(range(23))
    tails = [list(Loader(_Rows(), 22, _collate, host_shard=(p, 2),
                         split_tail=True))[-1] for p in range(2)]
    assert len(tails[0]["i"]) == 1 and tails[1] == {}


# --- one rank ---------------------------------------------------------------

def test_one_rank_group_step_is_bit_for_bit(tmp_path):
    """A gloo group of one rank: the mesh step (its collectives run) gives
    the plain ``make_multi_steps``' losses and masters bit for bit, over
    two steps with momentum and an eval step."""
    args = _model_args()
    init = MultiModel(dtype=torch.float32, **args).state_dict()
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    out = {}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        for route in ("plain", "mesh"):
            model = MultiModel(dtype=torch.float32, **args)
            tx = make_optimizer(OptimConfig(lr=1e-2, momentum=0.9))
            state = create_train_state(model, init, tx)
            mesh = create_mesh(device="cpu") if route == "mesh" else None
            assert mesh is None or mesh.distributed
            train_step, eval_step = make_multi_steps(model, tx, 4, mesh=mesh)
            losses_ = [train_step(state, batch, 0)[1] for _ in range(2)]
            out[route] = (losses_, eval_step(state, batch)["loss"],
                          state.params)
    finally:
        dist.destroy_process_group()
    for a, b in zip(out["plain"][0] + [out["plain"][1]],
                    out["mesh"][0] + [out["mesh"][1]]):
        assert torch.equal(a, b)
    for name, master in out["plain"][2].items():
        assert torch.equal(master, out["mesh"][2][name]), name
