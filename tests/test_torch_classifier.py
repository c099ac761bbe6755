"""The supervised classifiers (``models/classifier.py``, the builders of
``models/build.py``) and their steps (``train/loop.py``
``make_classifier_steps``) against the JAX package's, on weights converted
by ``convert.py``, in f32:

* logits of ``ImageClassifier`` (a narrow ViT, and B0 at 24 px with
  random running statistics) and ``ProfileClassifier`` (a transformer
  over ragged profiles, so the key-padding mask is live, and the CNN)
  within 1e-4 of max(1, max|logit|);
* one dropout-0 train step against JAX's ``make_classifier_steps`` (its
  optimizer an SGD at lr 1 that keeps the gradients in its state): the
  loss within 1e-5 relative, every gradient within 1e-3 relative L2 of
  JAX's (one that JAX gives as a structural zero, below 1e-4 of the
  median, must be as small), every master's update within 1e-3
  relative L2, and the CNN's updated running statistics within 1e-4 of
  max(1, |·|); the eval step's loss, ``pred`` and ``label``; both sides
  on the same random weights (no init is compiled). B0's cases are in
  ``tests/test_torch_classifier_b0.py`` (``check_forward_step``: its
  train step's loss and statistics against JAX's forward), the
  module-6 encoders' in ``tests/test_torch_backbone_steps.py`` and
  ``tests/test_torch_lstm.py`` (this file's harness and cases);
* bf16 logits into the cross-entropy: the port takes ``log_softmax`` of
  the bf16 logits as JAX does; the two bf16 losses within 2 bf16 steps.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu import config as jax_config
from multimodal_plankton_recognition_tpu.models import build as jax_build
from multimodal_plankton_recognition_tpu.ops.losses import (
    cross_entropy_loss as jax_cross_entropy,
)
from multimodal_plankton_recognition_tpu.train.loop import (
    make_classifier_steps as jax_make_classifier_steps,
)
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.convert import from_flax
from multimodal_plankton_recognition_torch.data.tokenize import (
    tokenize_lstm, tokenize_transformer,
)
from multimodal_plankton_recognition_torch.models import build
from multimodal_plankton_recognition_torch.models.classifier import (
    ImageClassifier, ProfileClassifier,
)
from multimodal_plankton_recognition_torch.ops.losses import (
    cross_entropy_loss,
)
from multimodal_plankton_recognition_torch.train import (
    create_train_state, make_classifier_steps, make_optimizer,
)
from torch_threads import single_thread

LOGIT_TOL, LOSS_TOL, GRAD_TOL, UPDATE_TOL, STATS_TOL = (1e-4, 1e-5, 1e-3,
                                                         1e-3, 1e-4)
STRUCTURAL_ZERO = 1e-4  # of the median gradient RMS
LOOSE_TOL = 1e-2  # check_train_step's ``loose`` parameters
N_CLASSES = 5
BS = 16
VIT = {"name": "vit_tiny_patch16_224", "in_chans": 1, "metadata": True,
       "fused_attention": True, "dropout": 0.0,
       "backbone_kwargs": {"img_size": 32, "depth": 2, "embed_dim": 48,
                           "num_heads": 3}}
B0 = {"name": "efficientnet_b0", "in_chans": 1, "metadata": True,
      "dropout": 0.0}
TRANSFORMER = {"kind": "transformer", "dim_in": 6, "dim_hidden": 64,
               "num_layers": 2, "num_head": 4, "target_size": 40,
               "dim_feedforward": 96, "fused_attention": True,
               "dropout": 0.0}
CNN = {"kind": "cnn", "dim_in": 6, "blocks": [1, 1, 1, 1],
       "base_channels": 8, "dropout": 0.0}
LSTM = {"kind": "lstm", "dim_in": 6, "dim_hidden": 128, "num_layers": 2,
        "dropout": 0.0}
# kind, encoder args, image size: the image cards' target_size is the
# ViT's 32 px and B0's 24 (B0 at B 16: at B 4 its last blocks normalize 4
# values a channel and f32 rounding alone passes 1e-4); the module-6
# backbones at 32 px (their cases run at reduced depth in
# tests/test_torch_backbone_steps.py, the LSTM's in tests/test_torch_lstm.py)
CASES = {"image-vit": ("image", VIT, 32), "image-b0": ("image", B0, 24),
         "profile-transformer": ("profile", TRANSFORMER, None),
         "profile-cnn": ("profile", CNN, None),
         **{f"image-{name}": ("image", {"name": name, "in_chans": 1,
                                        "metadata": True, "dropout": 0.0},
                              32)
            for name in ("resnet18", "resnet50")},
         "image-densenet121": ("image", {"name": "densenet121", "in_chans": 1,
                                         "metadata": True, "dropout": 0.0},
                               32),
         "profile-lstm": ("profile", LSTM, None)}
# the cases whose model has BatchNorm running statistics
BN_CASES = {"image-b0", "profile-cnn", "image-resnet18", "image-resnet50",
            "image-densenet121"}


def _card(case: str) -> dict:
    kind, args, size = CASES[case]
    d = {"bs": BS, "max_len": 40, "target_size": size or 224,
         # plain SGD at lr 1: an update is -g, as the JAX side's
         "optim_args": {"lr": 1.0, "momentum": 0.0, "weight_decay": 0.0,
                        "nesterov": False},
         "trainer_args": {"precision": "32"}}
    d[f"{kind}_encoder_args"] = copy.deepcopy(args)
    return d


def _batch(case: str, seed: int = 0) -> dict:
    """A classifier batch (numpy) with ``label``: images with their
    shapes, or profiles of ragged lengths tokenized as the profile
    driver does (``max_len + 1`` tokens for a transformer, ``max_len`` for
    the CNN and the LSTM, with its ``last_idx``)."""
    kind, args, size = CASES[case]
    rs = np.random.RandomState(seed)
    label = (np.arange(BS) % N_CLASSES).astype(np.int32)
    if kind == "image":
        return {"image": rs.randn(BS, size, size, 1).astype(np.float32),
                "image_shape": rs.randint(50, 400, (BS, 2)).astype(np.int32),
                "label": label}
    if args["kind"] == "transformer":
        lengths = rs.randint(5, 41, BS)
        tokens = tokenize_transformer(
            [rs.randn(n, 6).astype(np.float32) for n in lengths], 40,
            pad_to=41)
        assert tokens["padding_mask"].any()
    elif args["kind"] == "lstm":
        lengths = rs.randint(5, 41, BS)
        tokens = tokenize_lstm(
            [rs.randn(n, 6).astype(np.float32) for n in lengths], pad_to=40)
        assert (tokens["last_idx"] < 39).any()
    else:
        tokens = {"profile": rs.randn(BS, 40, 6).astype(np.float32)}
    return {**tokens, "label": label,
            "profile_len": rs.randint(20, 2000, (BS, 1)).astype(np.int32)}


def _names():
    return [f"genus_{i}" for i in range(N_CLASSES)]


def _random_variables(shapes, seed=1):
    """Random weights for a Flax tree of ``shapes`` (``jax.eval_shape`` of
    the module's init, so no init is compiled): kernels N(0, 1/fan_in),
    biases and token tables small, scales around 1, running means around
    0 and variances in [0.5, 1.5] (so eval mode normalizes with something
    other than 0 / 1)."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        x = rs.randn(*shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * x
        if name == "var":
            return (0.5 + rs.rand(*shape)).astype(np.float32)
        return 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _record_grads():
    """An optax transform whose update is -g (SGD at lr 1) and whose state
    keeps g, so JAX's step hands back its own gradients."""
    import optax

    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return jax.tree.map(jnp.negative, grads), {"g": grads}

    return optax.GradientTransformation(init, update)


def _jax_model(case: str):
    """The JAX classifier of a case and random variables for it."""
    kind = CASES[case][0]
    jcard = jax_config.ModelCard.from_dict(_card(case))
    jmodel = getattr(jax_build, f"build_{kind}_classifier")(jcard, _names())
    inputs = {k: jnp.asarray(v) for k, v in _batch(case).items()
              if k != "label"}
    return jmodel, _random_variables(dict(jax.eval_shape(
        jmodel.init, jax.random.key(0), **inputs)))


def _inputs(case: str, seed: int):
    return {k: jnp.asarray(v) for k, v in _batch(case, seed).items()
            if k != "label"}


@functools.cache
def _jax_run(case: str):
    """The JAX side of a case, in the port's names: the classifier's
    variables, its eval logits on batch 2, and on batch 3 the eval step's
    output, then one train step of ``make_classifier_steps`` (SGD at lr 1:
    the masters move by -g): its loss, gradients and variables after."""
    from multimodal_plankton_recognition_tpu.train.state import TrainState

    jmodel, variables = _jax_model(case)
    logits = jax.jit(lambda v, x: jmodel.apply(v, train=False, **x))(
        variables, _inputs(case, 2))
    tx = _record_grads()
    state = TrainState(step=0, params=variables["params"],
                       batch_stats=variables.get("batch_stats", {}),
                       opt_state=tx.init(variables["params"]))
    train_step, eval_step = jax_make_classifier_steps(jmodel, tx)
    batch = {k: jnp.asarray(v) for k, v in _batch(case, seed=3).items()}
    evaluated = jax.tree.map(np.asarray, eval_step(state, batch))
    state, loss = train_step(state, batch, jax.random.key(1))
    after = {"params": state.params}
    if "batch_stats" in variables:
        after["batch_stats"] = state.batch_stats
    return {"variables": variables, "logits": np.asarray(logits),
            "eval": evaluated, "loss": float(loss),
            "grads": from_flax({"params": jax.tree.map(
                np.asarray, state.opt_state["g"])}),
            "after": from_flax(jax.tree.map(np.asarray, after))}


def _port_model(case: str, variables):
    kind = CASES[case][0]
    card = config.ModelCard.from_dict(_card(case))
    model = getattr(build, f"build_{kind}_classifier")(card, _names())
    assert isinstance(model, ImageClassifier if kind == "image"
                      else ProfileClassifier)
    model.load_state_dict(from_flax(variables), strict=True)
    return model, card


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


# B0's cases are in tests/test_torch_classifier_b0.py, the module-6 ones
# in tests/test_torch_backbone_steps.py and tests/test_torch_lstm.py
FILE_CASES = ["image-vit", "profile-transformer", "profile-cnn"]


@pytest.mark.parametrize("case", FILE_CASES)
def test_logits_match_jax(case):
    check_logits(case)


def check_logits(case, run=None):
    want = (run or _jax_run)(case)
    model, _ = _port_model(case, want["variables"])
    inputs = {k: v for k, v in _batch(case, seed=2).items() if k != "label"}
    got = model.eval()(**_tensors(inputs))
    assert got.shape == (BS, N_CLASSES) and got.dtype == torch.float32
    _close(got, want["logits"], LOGIT_TOL, case)


@pytest.mark.parametrize("case", FILE_CASES)
def test_train_step_matches_jax(case):
    check_train_step(case)


def check_train_step(case, prepare=None, loose=()):
    """``prepare(model)``, when given, runs on the port's model before
    its steps (a test's forward hooks); the parameters named in ``loose``
    have their gradient and update held to ``LOOSE_TOL`` (a caller says
    why)."""
    want = _jax_run(case)
    model, card = _port_model(case, want["variables"])
    if prepare is not None:
        prepare(model)
    batch = _tensors(_batch(case, seed=3))
    tx = make_optimizer(card.optim_args)
    init = from_flax(want["variables"])
    state = create_train_state(model, init, tx)
    train_step, eval_step = make_classifier_steps(model, tx)
    evaluated = eval_step(state, batch)
    assert abs(evaluated["loss"].item() - float(want["eval"]["loss"])) \
        <= LOSS_TOL * abs(float(want["eval"]["loss"]))
    np.testing.assert_array_equal(evaluated["pred"].numpy(),
                                  want["eval"]["pred"])
    np.testing.assert_array_equal(evaluated["label"].numpy(),
                                  want["eval"]["label"])
    state, loss = train_step(state, batch, 0)
    assert abs(loss.item() - want["loss"]) <= LOSS_TOL * abs(want["loss"])
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want["grads"]) == sorted(state.params)
    rms = {n: (g.double().norm() / g.numel() ** 0.5).item()
           for n, g in want["grads"].items()}
    median = float(np.median(list(rms.values())))
    errs, zeros = {}, {}
    for n, g in want["grads"].items():
        got = named[n].grad.double()
        if rms[n] < STRUCTURAL_ZERO * median:
            zeros[n] = (got.norm() / got.numel() ** 0.5).item() / median
            continue
        errs[n] = ((got - g.double()).norm() / g.double().norm()).item()
        delta = state.params[n].double() - init[n].double()
        w = want["after"][n].double() - init[n].double()
        errs[f"update {n}"] = ((delta - w).norm() / w.norm()).item()
    for n in loose:
        assert max(errs.pop(n), errs.pop(f"update {n}")) <= LOOSE_TOL, n
    worst = max(errs, key=errs.get)
    assert errs[worst] <= max(GRAD_TOL, UPDATE_TOL), (worst, errs[worst])
    assert all(z < STRUCTURAL_ZERO for z in zeros.values()), zeros
    stats = dict(model.named_buffers())
    assert bool(stats) == (case in BN_CASES)
    for n, buf in stats.items():
        assert buf.dtype == torch.float32, n
        assert not torch.equal(buf, init[n])
        _close(buf, want["after"][n].numpy(), STATS_TOL, n)


def test_classifier_builders_refuse_unported_encoders():
    """Named for the refusals the module-6 encoders met before queue 1
    module 6 was ported: the builders now give each classifier, and one
    f32 train step on the CPU (32 px, 16 profile steps, B 4, one PyTorch
    thread) gives a finite loss and a gradient on every parameter."""
    with single_thread():
        _module_6_builders_train()


def _module_6_builders_train():
    rs = np.random.RandomState(0)
    for kind, args in (("image", {"name": "resnet18"}),
                       ("image", {"name": "densenet121"}),
                       ("profile", {"kind": "lstm", "dim_in": 6,
                                    "dim_hidden": 8})):
        d = {f"{kind}_encoder_args": args,
             "trainer_args": {"precision": "32"}}
        card = config.ModelCard.from_dict(d)
        model = getattr(build, f"build_{kind}_classifier")(card, _names())
        if kind == "image":
            batch = {"image": rs.randn(4, 32, 32, 1),
                     "image_shape": rs.randint(50, 400, (4, 2))}
        else:
            batch = {"profile": rs.randn(4, 16, 6),
                     "last_idx": np.array([15, 3, 9, 0]),
                     "profile_len": rs.randint(20, 2000, (4, 1))}
        batch = {k: torch.as_tensor(v, dtype=torch.float32
                                    if v.dtype == np.float64 else None)
                 for k, v in batch.items()}
        batch["label"] = torch.arange(4) % N_CLASSES
        tx = make_optimizer(card.optim_args)
        state = create_train_state(model, model.state_dict(), tx)
        train_step, _ = make_classifier_steps(model, tx)
        state, loss = train_step(state, batch, 0)
        assert torch.isfinite(loss) and state.step == 1
        assert all(p.grad is not None for p in model.parameters())


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_logits_cross_entropy(seed):
    """bf16 logits go into ``log_softmax`` as they are (JAX's
    ``cross_entropy_loss`` does not upcast): a bf16 loss, within 2 bf16
    steps of JAX's; both near the f32 loss of the same logits."""
    rs = np.random.RandomState(seed)
    logits = (4 * rs.randn(64, 38)).astype(np.float32)
    label = rs.randint(0, 38, 64).astype(np.int32)
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    got = cross_entropy_loss(lb, torch.from_numpy(label))
    want = jax_cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                             jnp.asarray(label))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    step = 2.0 ** -7 * abs(float(want))  # a bf16 step near the loss
    assert abs(got.item() - float(want)) <= 2 * step
    f32 = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(label)).item()
    assert abs(got.item() - f32) <= 4 * step


@pytest.mark.parametrize("kind", ["image", "profile"])
def test_seeded_init_draws_fc_as_flax(kind):
    """The drivers' seeded init gives the head Flax's ``nn.Dense``
    distribution: a zero bias and a ``lecun_normal`` kernel (a normal
    truncated at 2 std, std 1/sqrt(fan_in)), by statistics against
    Flax's own draw of that shape."""
    from flax import linen as fnn

    from multimodal_plankton_recognition_torch.train.drivers import (
        init_masters,
    )

    case = "image-vit" if kind == "image" else "profile-transformer"
    names = [f"c{i}" for i in range(200)]
    got = init_masters(config.ModelCard.from_dict(_card(case)), kind, names)
    w, b = got["fc.weight"].double(), got["fc.bias"]
    fan_in = w.shape[1]
    want = np.asarray(fnn.initializers.lecun_normal()(
        jax.random.key(0), (fan_in, len(names)), jnp.float32), np.float64)
    assert not b.any() and w.shape == (len(names), fan_in)
    n, sw = w.numel(), want.std()
    assert abs(w.mean().item() - want.mean()) <= 6 * sw / np.sqrt(n)
    assert abs(w.std().item() - sw) <= 6 * sw / np.sqrt(n)
    assert abs(sw - 1 / np.sqrt(fan_in)) <= 6 * sw / np.sqrt(n)
    # a unit normal truncated to [-2, 2] (std 0.8796), scaled to std
    # 1/sqrt(fan_in): nothing beyond its cut
    cut = 2 / 0.87962566103423978 / np.sqrt(fan_in) * (1 + 1e-6)
    assert w.abs().max().item() <= cut and np.abs(want).max() <= cut


@functools.cache
def _jax_forward_run(case: str):
    """The forward half of ``_jax_run`` in one compiled call (for B0,
    whose train-step compile alone takes most of a minute under the
    suite's workers): the eval logits on batch 2; on batch 3 the eval
    step's loss and pred, and the train-mode loss and updated running
    statistics that ``make_classifier_steps``' loss function computes."""
    jmodel, variables = _jax_model(case)
    label = jnp.asarray(_batch(case, 3)["label"])

    def forward(v, x2, x3):
        eval_logits = jmodel.apply(v, train=False, **x3)
        train_logits, updated = jmodel.apply(
            v, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(1)}, **x3)
        return (jmodel.apply(v, train=False, **x2),
                jax_cross_entropy(eval_logits, label),
                jnp.argmax(eval_logits, axis=-1),
                jax_cross_entropy(train_logits, label), updated)

    logits, eval_loss, pred, loss, updated = jax.tree.map(
        np.asarray, jax.jit(forward)(variables, _inputs(case, 2),
                                     _inputs(case, 3)))
    return {"variables": variables, "logits": logits,
            "eval": {"loss": eval_loss, "pred": pred, "label": label},
            "loss": float(loss),
            "after": from_flax({"params": {}, **updated})}


def check_forward_step(case):
    """``check_train_step`` without JAX's gradients: the eval step, the
    train step's loss and its updated running statistics against
    ``_jax_forward_run``."""
    want = _jax_forward_run(case)
    model, card = _port_model(case, want["variables"])
    batch = _tensors(_batch(case, seed=3))
    tx = make_optimizer(card.optim_args)
    init = from_flax(want["variables"])
    state = create_train_state(model, init, tx)
    train_step, eval_step = make_classifier_steps(model, tx)
    evaluated = eval_step(state, batch)
    assert abs(evaluated["loss"].item() - float(want["eval"]["loss"])) \
        <= LOSS_TOL * abs(float(want["eval"]["loss"]))
    np.testing.assert_array_equal(evaluated["pred"].numpy(),
                                  want["eval"]["pred"])
    state, loss = train_step(state, batch, 0)
    assert abs(loss.item() - want["loss"]) <= LOSS_TOL * abs(want["loss"])
    stats = dict(model.named_buffers())
    assert stats and sorted(stats) == sorted(want["after"])
    for n, buf in stats.items():
        assert buf.dtype == torch.float32, n
        assert not torch.equal(buf, init[n])
        _close(buf, want["after"][n].numpy(), STATS_TOL, n)
