"""The port's train steps on two gloo ranks against the JAX package's on a
2-device CPU mesh, from the same converted weights (dropout 0, f32):

* a tiny ViT + ProfileTransformer model, CLIP and SigLIP × bucketed and
  global negatives × both parallel modes: the port's ``make_multi_steps``
  with a mesh against JAX's GSPMD ``make_multi_steps`` (state replicated,
  batch sharded), the port's ``make_multi_steps_shard_map`` against
  JAX's; the global-negatives GSPMD case (one bucket over two ranks)
  runs the port's gathered-embeddings route;
* a tiny BatchNorm model (the ViT + a ProfileCNN with BatchNorm) under
  GSPMD: the synchronised statistics, against JAX's GSPMD step and the
  port's one-process step over the global batch; ``parallel: shard_map``
  with it raises JAX's error;
* an EfficientNet-B0 model with ``fused_mbconv: true`` on two ranks takes
  the plain MBConv route with synchronised statistics, and equals the
  one-process step of the same weights with ``fused_mbconv: false``.

Tolerances: the loss to 1e-5 relative; every master, every momentum
buffer (after one step, the gradient plus the weight decay) and every
running statistic to 1e-4 relative L2; every update (masters minus their
initial values) to 1e-3 relative L2, as the one-process f32 parity of
``tests/test_torch_train.py``. The BatchNorm model's ReLUs (ProfileCNN)
sit away from their kinks on these inputs: the one-process and
two-rank port steps, whose statistics differ only in summation order,
are held to the same bounds. In B0 some parameters' gradients vanish
through a following BatchNorm (their updates, and the running means of
inputs whose mean is zero, are f32 noise, 1e-9 against 1e-2): there each
update, momentum buffer and running statistic is held to 1e-4 relative
L2 plus 1e-6 of the largest one's norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.config import (
    OptimConfig as JaxOptimConfig,
)
from multimodal_plankton_recognition_tpu.models.multi import (
    MultiModel as JaxMultiModel,
)
from multimodal_plankton_recognition_tpu.parallel.mesh import (
    create_mesh as jax_create_mesh, replicate_state as jax_replicate,
    shard_batch as jax_shard_batch,
)
from multimodal_plankton_recognition_tpu.train import (
    create_train_state as jax_create_train_state,
    make_multi_steps as jax_make_multi_steps,
    make_multi_steps_shard_map as jax_make_multi_steps_shard_map,
    make_optimizer as jax_make_optimizer,
)
from multimodal_plankton_recognition_torch.config import OptimConfig
from multimodal_plankton_recognition_torch.convert import from_flax
from multimodal_plankton_recognition_torch.data.tokenize import (
    tokenize_transformer,
)
from multimodal_plankton_recognition_torch.models.multi import MultiModel
from multimodal_plankton_recognition_torch.parallel.mesh import create_mesh
from multimodal_plankton_recognition_torch.train import (
    create_train_state, make_multi_steps, make_multi_steps_shard_map,
    make_optimizer,
)
from torch_ranks import Ranks
from torch_threads import one_thread  # noqa: F401

LOSS_TOL, REL_L2_TOL, UPDATE_TOL = 1e-5, 1e-4, 1e-3
NOISE_FLOOR = 1e-6  # of the largest update, B0's vanishing gradients
BS, IMG, TS, BUCKETS = 8, 16, 8, 4
OPTIM = {"lr": 1e-2, "momentum": 0.9, "weight_decay": 1e-4,
         "nesterov": True}


def _model_args(method="clip", profile=None, image=None) -> dict:
    return dict(
        dim_embed=16,
        image_encoder_args=image or {
            "name": "vit_tiny_patch16_224", "in_chans": 1, "metadata": True,
            "fused_attention": True, "dropout": 0.0,
            "backbone_kwargs": {"img_size": IMG, "depth": 1,
                                "embed_dim": 32, "num_heads": 2}},
        profile_encoder_args=profile or {
            "kind": "transformer", "dim_in": 6, "dim_hidden": 32,
            "num_layers": 1, "num_head": 2, "target_size": TS,
            "dim_feedforward": 64, "fused_attention": True,
            "dropout": 0.0},
        coordination_args={"method": method, "fused": True})


BN_PROFILE = {"kind": "cnn", "dim_in": 6, "blocks": [1, 1, 1, 1],
              "base_channels": 8, "dropout": 0.0}


def _batch(seed: int = 0, profile_kind: str = "transformer",
           img: int = IMG) -> dict:
    rs = np.random.RandomState(seed)
    lengths = rs.randint(3, TS + 1, BS)
    lengths[0] = TS
    profiles = [rs.randn(n, 6).astype(np.float32) for n in lengths]
    if profile_kind == "transformer":
        tokens = tokenize_transformer(profiles, TS, pad_to=TS + 1)
    else:
        stack = np.zeros((BS, TS, 6), np.float32)
        for row, p in zip(stack, profiles):
            row[:len(p)] = p
        tokens = {"profile": stack}
    return {"image": rs.randn(BS, img, img, 1).astype(np.float32),
            "image_shape": rs.randint(200, 400, (BS, 2)).astype(np.int32),
            "profile_len": rs.randint(100, 2000, (BS, 1)).astype(np.int32),
            **tokens}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = Ranks(2, tmp_path_factory.mktemp("parallel_steps"))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_create_mesh(n_data=2, devices=jax.devices()[:2])


def _trace(opt_state):
    """The optax SGD momentum trace in a (chained) optimizer state."""
    for node in jax.tree.leaves(opt_state,
                                is_leaf=lambda x: hasattr(x, "trace")):
        if hasattr(node, "trace"):
            return node.trace
    raise AssertionError("no trace in the optimizer state")


def _jax_step(model_args, batch, mode, negatives, buckets, mesh):
    """The JAX package's initial weights and, after one step on the
    2-device mesh, its loss, eval loss, masters, momentum and BatchNorm
    statistics, in the port's names."""
    model = JaxMultiModel(dtype=jnp.float32, **model_args)
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jax_create_train_state(model, jax.random.key(0), jbatch, tx,
                                   init_kwargs={"buckets": buckets})
    init = from_flax({"params": jax.tree.map(np.asarray, state.params),
                      **({"batch_stats": jax.tree.map(
                          np.asarray, state.batch_stats)}
                         if state.batch_stats else {})})
    if mode == "shard_map":
        train_step, eval_step = jax_make_multi_steps_shard_map(
            model, tx, mesh, buckets=buckets, negatives=negatives)
    else:
        train_step, eval_step = jax_make_multi_steps(
            model, tx, 1 if negatives == "global" else buckets)
    state = jax_replicate(jax.tree.map(jnp.copy, state), mesh)
    state, loss = train_step(state, jax_shard_batch(dict(jbatch), mesh),
                             jax.random.key(1))
    ev = eval_step(state, jax_shard_batch(dict(jbatch), mesh))
    after = {"loss": float(loss), "eval": float(ev["loss"]),
             "params": from_flax({"params": jax.tree.map(np.asarray,
                                                         state.params)}),
             "momentum": from_flax({"params": jax.tree.map(
                 np.asarray, _trace(state.opt_state))})}
    if state.batch_stats:
        full = from_flax({"params": jax.tree.map(np.asarray, state.params),
                          "batch_stats": jax.tree.map(np.asarray,
                                                      state.batch_stats)})
        after["batch_stats"] = {k: v for k, v in full.items()
                                if k.endswith(("running_mean",
                                               "running_var"))}
    return {k: v.numpy() for k, v in init.items()}, after


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _hold(got: dict, want: dict, init: dict, what: str) -> None:
    assert abs(got["losses"][0] - want["loss"]) <= LOSS_TOL * abs(
        want["loss"]), (what, got["losses"][0], want["loss"])
    assert abs(got["eval"] - want["eval"]) <= LOSS_TOL * abs(want["eval"]), \
        (what, got["eval"], want["eval"])
    for name, master in want["params"].items():
        master = np.asarray(master)
        assert _rel_l2(got["params"][name], master) <= REL_L2_TOL, \
            (what, name)
        update = master - init[name]
        if np.linalg.norm(update) > 0:
            err = _rel_l2(got["params"][name] - init[name], update)
            assert err <= UPDATE_TOL, (what, name, err)
        assert _rel_l2(got["momentum"][name],
                       want["momentum"][name]) <= REL_L2_TOL, (what, name)
    for name, stat in want.get("batch_stats", {}).items():
        assert _rel_l2(got["batch_stats"][name], stat) <= REL_L2_TOL, \
            (what, name)


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
@pytest.mark.parametrize("negatives", ["bucketed", "global"])
@pytest.mark.parametrize("method", ["clip", "siglip"])
def test_step_matches_jax_mesh(method, negatives, mode, ranks, jax_mesh):
    """One step and one eval step on 2 ranks against JAX's step of the same
    mode on the 2-device mesh: loss, eval loss, masters, updates and the
    momentum buffers."""
    args = _model_args(method)
    batch = _batch()
    buckets = BUCKETS if negatives == "bucketed" else 1
    init, want = _jax_step(args, batch, mode, negatives, buckets, jax_mesh)
    got = ranks.run("multi_step", args, init, batch, mode, negatives,
                    buckets, OPTIM)
    for rank in got:
        _hold(rank, want, init, f"{method} {negatives} {mode}")
    # every rank ends with the same masters, bit for bit
    for name in init:
        np.testing.assert_array_equal(got[0]["params"][name],
                                      got[1]["params"][name])


def _one_process(args, init, batch, buckets):
    model = MultiModel(dtype=torch.float32, **args)
    tx = make_optimizer(OptimConfig(**OPTIM))
    state = create_train_state(
        model, {k: torch.as_tensor(v) for k, v in init.items()}, tx)
    train_step, eval_step = make_multi_steps(model, tx, buckets)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    state, loss = train_step(state, tbatch, 0)
    return {"loss": float(loss), "eval": float(eval_step(state, tbatch)[
        "loss"]), "params": {n: m.numpy() for n, m in state.params.items()},
        "momentum": {n: state.opt.state[m]["momentum_buffer"].numpy()
                     for n, m in state.params.items()},
        "batch_stats": {n: b.numpy() for n, b in state.batch_stats.items()}}


def test_batchnorm_statistics_are_synchronised(ranks, jax_mesh):
    """A BatchNorm model (ProfileCNN) under GSPMD on 2 ranks: loss,
    masters, momentum and running statistics against JAX's GSPMD step and
    against the port's one-process step over the global batch."""
    args = _model_args(profile=BN_PROFILE)
    batch = _batch(profile_kind="cnn")
    init, want = _jax_step(args, batch, "gspmd", "bucketed", 2, jax_mesh)
    assert want["batch_stats"]
    got = ranks.run("multi_step", args, init, batch, "gspmd", "bucketed",
                    2, OPTIM)
    single = _one_process(args, init, batch, 2)
    for rank in got:
        _hold(rank, want, init, "batchnorm vs jax")
        _hold(rank, dict(single, loss=single["loss"]), init,
              "batchnorm vs one process")
        for name, stat in single["batch_stats"].items():
            assert _rel_l2(rank["batch_stats"][name], stat) <= REL_L2_TOL


def test_shard_map_refuses_batchnorm():
    model = MultiModel(dtype=torch.float32,
                       **_model_args(profile=BN_PROFILE))
    tx = make_optimizer(OptimConfig(**OPTIM))
    with pytest.raises(ValueError, match="BatchNorm-free model"):
        make_multi_steps_shard_map(model, tx, create_mesh(device="cpu"))


def test_fused_mbconv_takes_the_synchronised_route(ranks):
    """B0 with ``fused_mbconv: true`` on 2 ranks: no block takes the fused
    route (the rank prints why, once), and the step equals the
    one-process step of ``fused_mbconv: false`` on the same weights."""
    image = {"name": "efficientnet_b0", "in_chans": 1, "metadata": True,
             "dropout": 0.0}
    fused = _model_args(profile=BN_PROFILE,
                        image=dict(image, fused_mbconv=True))
    plain = _model_args(profile=BN_PROFILE, image=image)
    batch = _batch(profile_kind="cnn", img=32)
    from multimodal_plankton_recognition_torch.models.initializers import (
        init_weights_,
    )
    init = {k: v.numpy() for k, v in init_weights_(
        MultiModel(dtype=torch.float32, **plain),
        torch.Generator().manual_seed(0)).state_dict().items()}
    got = ranks.run("multi_step", fused, init, batch, "gspmd", "bucketed",
                    2, OPTIM, fused_calls=True)
    assert [rank["fused_calls"] for rank in got] == [0, 0]
    for rank in got:
        assert rank["printed"].count("takes the unfused MBConv route") == 1
    single = _one_process(plain, init, batch, 2)
    for rank in got:
        assert abs(rank["losses"][0] - single["loss"]) <= LOSS_TOL * abs(
            single["loss"])
        want = {n: m - init[n] for n, m in single["params"].items()}
        _close_with_floor("updates", {n: rank["params"][n] - init[n]
                                      for n in want}, want)
        _close_with_floor("momentum", rank["momentum"], single["momentum"])
        _close_with_floor("statistics", rank["batch_stats"],
                          single["batch_stats"])


def _close_with_floor(what, have, want):
    """Each tensor within 1e-4 relative L2 plus ``NOISE_FLOOR`` of the
    largest tensor's norm."""
    floor = NOISE_FLOOR * max(np.linalg.norm(v) for v in want.values())
    for name, w in want.items():
        err = np.linalg.norm(np.float64(have[name]) - w)
        assert err <= REL_L2_TOL * np.linalg.norm(w) + floor, \
            (what, name, err, np.linalg.norm(w))
