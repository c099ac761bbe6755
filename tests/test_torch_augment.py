"""Device augmentation of the port (``ops/augment.py``) and the train
step's ``augment_fn`` (``train/loop.py``).

The apply step is held against the JAX package's ``multi_train_augment``
exactly, on JAX's own draws (replayed from its key splits), for the
transformer, lstm and cnn tokenize contracts. The port's draws (a torch
generator) are held by statistics: crop offsets cover their range, flips
come up about half the time (within 0.03 of 1/2 over 4,096 coins), the
noise's std is 1e-3 (within 3%). The step with ``augment_fn=None`` is the
step as it was, and an ``augment_fn`` leaves the dropout draws alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.ops.augment import (
    multi_train_augment as jax_multi_train_augment,
)
from multimodal_plankton_recognition_torch.config import OptimConfig
from multimodal_plankton_recognition_torch.data.tokenize import (
    tokenize_transformer,
)
from multimodal_plankton_recognition_torch.models.multi import MultiModel
from multimodal_plankton_recognition_torch.ops.augment import (
    apply_augment, draw_augment, multi_train_augment,
)
from multimodal_plankton_recognition_torch.train import (
    create_train_state, make_multi_steps, make_optimizer,
)
from multimodal_plankton_recognition_torch.train.loop import (
    AUGMENT_STREAM, _step_generator,
)

TS, OS = 32, 34  # target size and its oversize, ceil(1.05 * 32)


def _oversize_batch(seed: int, b: int = 5) -> dict:
    rs = np.random.RandomState(seed)
    return {"image": rs.uniform(-1, 1, (b, OS, OS, 1)).astype(np.float32),
            "profile": rs.randn(b, OS, 6).astype(np.float32),
            "image_shape": rs.randint(50, 400, (b, 2)).astype(np.int32),
            "profile_len": rs.randint(20, 2000, (b, 1)).astype(np.int32)}


def _jax_draws(key, batch) -> dict:
    """The draws JAX's ``multi_train_augment(batch, TS, key)`` makes, by
    its own key splits."""
    b, h, w, _ = batch["image"].shape
    length, d = batch["profile"].shape[1:]
    r_img, r_prof, r_vflip, r_joint, r_noise = jax.random.split(key, 5)
    ry, rx = jax.random.split(r_img)
    draws = {
        "dy": jax.random.randint(ry, (b,), 0, h - TS + 1),
        "dx": jax.random.randint(rx, (b,), 0, w - TS + 1),
        "start": jax.random.randint(r_prof, (b,), 0, length - TS + 1),
        "vflip": jax.random.bernoulli(r_vflip, 0.5, (b, 1, 1, 1)).reshape(b),
        "joint": jax.random.bernoulli(r_joint, 0.5, (b,)),
        "noise": jax.random.normal(r_noise, (b, TS, d), jnp.float32)}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["transformer", "lstm", "cnn"])
def test_apply_matches_jax_on_jax_draws(kind, seed):
    batch = _oversize_batch(seed)
    key = jax.random.key(seed)
    want = jax_multi_train_augment(
        {k: jnp.asarray(v) for k, v in batch.items()}, TS, key, kind=kind)
    draws = _jax_draws(key, batch)
    got = apply_augment({k: torch.from_numpy(v) for k, v in batch.items()},
                        draws, TS, kind)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].numpy().dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert got["image"].shape == (5, TS, TS, 1)


def test_draws_by_statistics():
    """Over 4,096 samples at the flagship's sizes (oversize 236, target
    224): every crop offset in [0, 12] turns up and none outside, each
    flip comes up about half the time, the noise is N(0, 1e-3)."""
    b, over, target = 4096, 236, 224
    batch = {"image": torch.zeros(b, over, over, 1),
             "profile": torch.zeros(b, over, 6)}
    draws = draw_augment(batch, target, torch.Generator().manual_seed(0))
    for k in ("dy", "dx", "start"):
        assert sorted(draws[k].unique().tolist()) == list(range(13)), k
    for k in ("vflip", "joint"):
        assert draws[k].dtype == torch.bool
        assert abs(draws[k].float().mean().item() - 0.5) < 0.03, k
    assert not torch.equal(draws["vflip"], draws["joint"])
    small = {"image": torch.zeros(b, over, over, 1),
             "profile": torch.zeros(b, over, 6)}
    out = apply_augment(small, draws, target, "cnn")
    noise = out["profile"]
    assert noise.shape == (b, target, 6)
    assert abs(noise.std().item() / 1e-3 - 1.0) < 0.03
    assert abs(noise.mean().item()) < 1e-5


def test_augment_is_a_function_of_the_generator():
    batch = {k: torch.from_numpy(v) for k, v in _oversize_batch(3).items()}

    def run(seed):
        return multi_train_augment(batch, TS, torch.Generator().manual_seed(
            seed), kind="transformer")

    a, b, c = run(0), run(0), run(1)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["profile"], c["profile"])
    assert a["time"].is_contiguous() and a["time"].dtype == torch.int32
    assert not a["padding_mask"].any()


def _model(dropout: float = 0.1) -> MultiModel:
    return MultiModel(
        dim_embed=16,
        image_encoder_args={
            "name": "vit_tiny_patch16_224", "in_chans": 1, "metadata": True,
            "fused_attention": True, "dropout": dropout,
            "backbone_kwargs": {"img_size": TS, "depth": 1, "embed_dim": 48,
                                "num_heads": 3}},
        profile_encoder_args={
            "kind": "transformer", "dim_in": 6, "dim_hidden": 32,
            "num_layers": 1, "num_head": 2, "target_size": TS,
            "dim_feedforward": 48, "fused_attention": True,
            "dropout": dropout},
        coordination_args={"method": "clip"})


def _run(augment_fn, batches, every_k=1):
    """Losses and state after ``batches``; ``augment_fn`` "absent" builds
    the step without the argument."""
    torch.manual_seed(0)
    model = _model()
    tx = make_optimizer(OptimConfig(lr=5e-2), every_k)
    state = create_train_state(model, model.state_dict(), tx)
    kw = {} if augment_fn == "absent" else {"augment_fn": augment_fn}
    step, _ = make_multi_steps(model, tx, 2, **kw)
    losses = []
    for b in batches:
        state, loss = step(state, b, 11)
        losses.append(loss)
    return losses, state


def _token_batch(seed: int) -> dict:
    rs = np.random.RandomState(seed)
    tokens = tokenize_transformer(
        [rs.randn(n, 6).astype(np.float32) for n in (TS, 7, 20, 31)], TS,
        pad_to=TS + 1)
    return {k: torch.from_numpy(v) for k, v in {
        "image": rs.randn(4, TS, TS, 1).astype(np.float32),
        "image_shape": rs.randint(200, 400, (4, 2)).astype(np.int32),
        "profile_len": rs.randint(100, 2000, (4, 1)).astype(np.int32),
        **tokens}.items()}


def test_step_without_augment_is_unchanged():
    """``augment_fn=None`` and an ``augment_fn`` that returns the batch as
    it is give the step of before bit for bit, dropout 0.1 included: the
    augmentation's generator is not the dropout's."""
    batches = [_token_batch(s) for s in range(3)]
    seen = []

    def identity(batch, generator):
        seen.append(generator.initial_seed())
        return batch

    base_losses, base = _run("absent", batches, every_k=2)
    plain_losses, plain = _run(None, batches, every_k=2)
    id_losses, ident = _run(identity, batches, every_k=2)
    for losses, state in ((plain_losses, plain), (id_losses, ident)):
        assert all(torch.equal(a, b) for a, b in zip(losses, base_losses))
        for n, m in base.params.items():
            assert torch.equal(state.params[n], m), n
    assert seen == [_step_generator(11, s, AUGMENT_STREAM).initial_seed()
                    for s in range(3)]
    # the dropout generator's seed is still SeedSequence([seed, step])'s
    assert [_step_generator(11, s).initial_seed() for s in range(3)] == [
        int(np.random.SeedSequence([11, s]).generate_state(1)[0])
        for s in range(3)]
    assert all(s != _step_generator(11, i).initial_seed()
               for i, s in enumerate(seen))


def test_step_runs_the_augmentation_before_the_loss():
    """The step with ``multi_train_augment`` on oversize batches equals the
    step without it on the batches augmented outside with the step's
    augmentation generators."""
    batches = [{k: torch.from_numpy(v)
                for k, v in _oversize_batch(s, b=4).items()}
               for s in range(2)]

    def augment(batch, generator):
        return multi_train_augment(batch, TS, generator, kind="transformer")

    got_losses, got = _run(augment, batches)
    outside = [augment(b, _step_generator(11, s, AUGMENT_STREAM))
               for s, b in enumerate(batches)]
    want_losses, want = _run(None, outside)
    assert all(torch.equal(a, b) for a, b in zip(got_losses, want_losses))
    for n, m in want.params.items():
        assert torch.equal(got.params[n], m), n
