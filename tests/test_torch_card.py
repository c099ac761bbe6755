"""Card path parity: the port's ``config.ModelCard`` against the JAX
package's for every shipped card and the bad cards, the smoke run's card
literal against its YAML file, ``models.build.build_multi_model`` and two
train micro-steps of a card-built model against the JAX step, and
``train.Fitter`` against the JAX ``Fitter``.

Train-step tolerances, as in ``tests/test_torch_train.py`` (relative L2
error of each master tensor's update, port against JAX): f32 — the loss to
1e-5 relative, every update to 1e-3; bf16 — the loss to 2e-3 relative,
the median update to 5e-2 and every update to 0.3 (the two frameworks
round bf16 intermediates at different points).
"""

import copy
import dataclasses
import functools
import importlib.util
import json
import math
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multimodal_plankton_recognition_tpu import config as jax_config
from multimodal_plankton_recognition_tpu.models.build import (
    build_multi_model as jax_build_multi_model,
)
from multimodal_plankton_recognition_tpu.train.early_stopping import (
    EarlyStopping as JaxEarlyStopping,
)
from multimodal_plankton_recognition_tpu.train.logging import (
    MetricsWriter as JaxMetricsWriter,
)
from multimodal_plankton_recognition_tpu.train.loop import (
    Fitter as JaxFitter, make_multi_steps as jax_make_multi_steps,
)
from multimodal_plankton_recognition_tpu.train.optim import (
    make_optimizer as jax_make_optimizer,
)
from multimodal_plankton_recognition_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.convert import from_flax
from multimodal_plankton_recognition_torch.data.tokenize import (
    tokenize_transformer,
)
from multimodal_plankton_recognition_torch.models.build import (
    build_multi_model, compute_dtype, step_buckets,
)
from multimodal_plankton_recognition_torch.train import (
    EarlyStopping, Fitter, MetricsWriter, create_train_state,
    make_multi_steps, make_optimizer,
)

REPO = Path(__file__).resolve().parent.parent
CARDS = sorted((REPO / "model_cards").rglob("*.yaml"))
SIGLIP_CARD = REPO / "model_cards/multi/vit_s_16_transformer_2_512_siglip.yaml"
B0_CARDS = [REPO / f"model_cards/multi/efficientnet_b0_cnn_2_512_{m}.yaml"
            for m in ("clip", "siglip")]
F32_LOSS_TOL, F32_UPDATE_TOL = 1e-5, 1e-3
# f32 with fused_ffn: the FFN rounds through bf16 on both sides, so an f32
# summation-order difference can flip one bf16 rounding of the hidden (a
# 2^-8 step); measured on this CPU: median 3.5e-4, largest 1.6e-3
FUSED_F32_MEDIAN_TOL, FUSED_F32_UPDATE_TOL = 1e-3, 5e-3
BF16_LOSS_TOL, BF16_MEDIAN_TOL, BF16_UPDATE_TOL = 2e-3, 5e-2, 0.3


def _load_yaml(path):
    return yaml.safe_load(path.read_text())


def _fields(card):
    return dataclasses.asdict(card), card.trainer_args._ignored


@pytest.mark.parametrize("path", CARDS, ids=lambda p: f"{p.parent.name}/"
                         f"{p.stem}")
def test_every_card_parses_as_in_jax(path):
    """Field by field, nested configs and the card's raw dict included;
    ``load_card`` (yaml imported inside it) gives the same card."""
    want = jax_config.load_card(path)
    got = config.ModelCard.from_dict(_load_yaml(path))
    assert _fields(got) == _fields(want)
    assert got.trainer_args.compute_dtype == want.trainer_args.compute_dtype
    assert got.oversize == want.oversize
    assert _fields(config.load_card(path)) == _fields(want)


@pytest.mark.parametrize("path", CARDS, ids=lambda p: f"{p.parent.name}/"
                         f"{p.stem}")
def test_json_card_loads_as_the_yaml_card(path, tmp_path):
    """The card's dict written as JSON: the port's ``load_card`` (json,
    no yaml) and the JAX package's (yaml, which reads JSON) give the card
    that each gives for the YAML file."""
    json_path = tmp_path / f"{path.stem}.json"
    json_path.write_text(json.dumps(_load_yaml(path)))
    want = _fields(jax_config.load_card(path))
    assert _fields(jax_config.load_card(json_path)) == want
    assert _fields(config.load_card(json_path)) == want
    assert _fields(config.load_card(path)) == want


BAD_CARDS = {
    "method": {"bs": 8, "coordination_args": {"method": "nope"}},
    "buckets": {"bs": 10, "buckets": 4},
    "bs": {"bs": 0},
    "image_key": {"bs": 8, "image_encoder_args": {"name": "resnet18",
                                                  "bogus": 1}},
    "image_name": {"bs": 8, "image_encoder_args": {"in_chans": 1}},
    "backbone_kwargs": {"bs": 8, "image_encoder_args": {
        "name": "vit_small_patch16_224", "backbone_kwargs": [1]}},
    "fixed_224": {"bs": 8, "target_size": 32, "image_encoder_args": {
        "name": "vit_small_patch16_224"}},
    "profile_kind": {"bs": 8, "profile_encoder_args": {"kind": "rnn"}},
    "profile_key": {"bs": 8, "profile_encoder_args": {"kind": "cnn",
                                                      "num_head": 2}},
    "position_table": {
        "bs": 8, "dim_embedding": 16, "target_size": 224,
        "profile_encoder_args": {"kind": "transformer", "dim_in": 6,
                                 "dim_hidden": 16, "num_head": 2,
                                 "target_size": 64}},
    "negatives": {"bs": 8, "coordination_args": {"method": "clip",
                                                 "negatives": "all"}},
    "parallel": {"bs": 8, "parallel": "pmap"},
    "top_level": {"bs": 8, "mystery": 1},
    "optim": {"bs": 8, "optim_args": {"lr": 1e-3, "beta": 0.9}},
}


@pytest.mark.parametrize("name", sorted(BAD_CARDS))
def test_bad_cards_raise_the_same_card_error(name):
    with pytest.raises(jax_config.CardError) as want:
        jax_config.ModelCard.from_dict(copy.deepcopy(BAD_CARDS[name]))
    with pytest.raises(config.CardError) as got:
        config.ModelCard.from_dict(copy.deepcopy(BAD_CARDS[name]))
    assert str(got.value) == str(want.value)
    assert issubclass(config.CardError, ValueError)


def test_smoke_card_literal_is_the_yaml_card():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.CARD == _load_yaml(SIGLIP_CARD)
    b0 = _load_yaml(B0_CARDS[0])
    b0["image_encoder_args"]["fused_mbconv"] = True
    assert smoke.B0_CARD == b0


def test_smoke_b0_siglip_literal_is_the_yaml_card():
    """The ``drive`` phase's card: the shipped B0 SigLIP YAML as it is."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.B0_SIGLIP_CARD == _load_yaml(B0_CARDS[1])


def test_siglip_card_builds_the_full_model():
    """ViT-S/16 (384 wide, 12 blocks, 6 heads), ProfileTransformer (128
    wide, 2 layers, 4 heads, 226-row position table), SigLIP head, bf16
    encoders and f32 scalars; buckets 4 and accumulation 4 from the card."""
    card = config.ModelCard.from_dict(_load_yaml(SIGLIP_CARD))
    model = build_multi_model(card)
    vit = model.image_encoder.backbone
    assert (vit.embed_dim, len(vit.blocks)) == (384, 12)
    assert vit.blocks[0].attn.num_heads == 6
    assert vit.pos_embed.shape == (1, 197, 384)
    prof = model.profile_encoder
    assert len(prof.layers) == 2 and prof.layers[0].attn.num_heads == 4
    assert prof.position.weight.shape == (226, 128)
    assert prof.layers[0].ff1.weight.shape == (1024, 128)
    assert model.image_projection.weight.shape == (512, 386)
    assert model.coordination.method == "siglip" and model.coordination.fused
    assert compute_dtype(card) == torch.bfloat16
    assert vit.pos_embed.dtype == torch.bfloat16
    assert model.coordination.logit_bias.dtype == torch.float32
    assert step_buckets(card) == 4
    assert card.trainer_args.accumulate_grad_batches == 4
    assert compute_dtype(config.ModelCard.from_dict(
        dict(_load_yaml(SIGLIP_CARD), trainer_args={"precision": "32"}))) \
        == torch.float32
    glob = config.ModelCard.from_dict(dict(
        _load_yaml(SIGLIP_CARD), coordination_args={
            "method": "siglip", "negatives": "global"}))
    assert step_buckets(glob) == 1


@pytest.mark.parametrize("field,key,value", [
    ("image_encoder_args", "remat", True),
    ("image_encoder_args", "remat", "conv_saves"),
    ("image_encoder_args", "pretrained_path", "weights.npz"),
    ("image_encoder_args", "pretrained", True),
])
def test_options_not_ported_raise(field, key, value, capsys):
    """Named for the refusals these options met before queue 1 module 6
    was ported: the ViT-S SigLIP card now builds with each (``remat``
    reaches an EfficientNet only, as in JAX; ``pretrained*`` are the
    drivers'), and the driver's state on a B0 CLIP card with the option
    trains one f32 step on the CPU (16 px images, 32 profile steps, one
    PyTorch thread): ``remat`` reaches the EfficientNet, ``pretrained:
    true`` with no path prints JAX's message."""
    from multimodal_plankton_recognition_torch.train import drivers
    from torch_threads import single_thread

    with single_thread():
        _option_builds_and_trains(field, key, value, capsys, drivers)


def _option_builds_and_trains(field, key, value, capsys, drivers):
    d = _load_yaml(SIGLIP_CARD)
    d[field][key] = value
    vit = build_multi_model(config.ModelCard.from_dict(d)).image_encoder
    assert vit.backbone_name == "vit_small_patch16_224"
    assert not hasattr(vit.backbone, "remat")

    small = _load_yaml(B0_CARDS[0])
    small.update(bs=4, buckets=1, trainer_args={"precision": "32"})
    small[field][key] = value
    card = config.ModelCard.from_dict(small)
    model, tx, state = drivers.multi_state(card, "cpu")
    if key == "remat":
        assert model.image_encoder.backbone.remat == value
    printed = capsys.readouterr().out
    assert ("no pretrained_path given; training from scratch"
            in printed) == (key == "pretrained")
    rs = np.random.RandomState(0)
    lengths = rs.randint(16, 33, 4)
    batch = {"image": rs.randn(4, 16, 16, 1).astype(np.float32),
             "image_shape": rs.randint(50, 400, (4, 2)).astype(np.int32),
             "profile": np.stack([np.pad(rs.randn(n, 6), ((0, 32 - n),
                                                          (0, 0)))
                                  for n in lengths]).astype(np.float32),
             "profile_len": lengths[:, None].astype(np.int32)}
    train_step, _ = make_multi_steps(model, tx, step_buckets(card))
    state, loss = train_step(state, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, 0)
    assert torch.isfinite(loss) and state.step == 1


@pytest.mark.parametrize("path", B0_CARDS, ids=lambda p: p.stem)
def test_fused_mbconv_builds(path):
    """Both B0 cards build with ``fused_mbconv`` true and false: the flag
    reaches every MBConv block as ``fused`` and changes no module; a ViT
    card ignores it, as the JAX ``ImageEncoder`` does."""
    trees = {}
    for flag in (False, True):
        d = _load_yaml(path)
        d["image_encoder_args"]["fused_mbconv"] = flag
        model = build_multi_model(config.ModelCard.from_dict(d))
        net = model.image_encoder.backbone
        assert {getattr(net, n).fused for n in net.block_names} == {flag}
        trees[flag] = {n: (tuple(t.shape), t.dtype)
                       for n, t in model.state_dict().items()}
    assert trees[True] == trees[False]
    d = _load_yaml(SIGLIP_CARD)
    d["image_encoder_args"]["fused_mbconv"] = True
    vit = build_multi_model(config.ModelCard.from_dict(d))
    assert vit.image_encoder.backbone.blocks[0].attn.fused


@pytest.mark.parametrize("field", ["image_encoder_args",
                                   "profile_encoder_args"])
def test_fused_ffn_builds(field):
    """``fused_ffn: true`` on either encoder of the ViT-S SigLIP card
    builds and reaches every block of that encoder only; the parameter
    tree is the unfused card's."""
    d = _load_yaml(SIGLIP_CARD)
    plain = build_multi_model(config.ModelCard.from_dict(copy.deepcopy(d)))
    d[field]["fused_ffn"] = True
    model = build_multi_model(config.ModelCard.from_dict(d))
    blocks = {"image_encoder_args": model.image_encoder.backbone.blocks,
              "profile_encoder_args": model.profile_encoder.layers}
    for name, layers in blocks.items():
        assert {b.fused_ffn for b in layers} == {name == field}
    assert {n: (t.shape, t.dtype) for n, t in model.state_dict().items()} \
        == {n: (t.shape, t.dtype) for n, t in plain.state_dict().items()}


ARCFACE = {"method": "arcface", "out_features": 5}


def _small_card(precision: str, method: str = "siglip",
                every_k: int = 2) -> dict:
    """The ViT-S SigLIP card shrunk: 32 px images, 2 ViT blocks (full
    width), a 64-wide profile transformer over 32 steps, bs 16 in 4
    buckets, dropout 0; ``method`` other than siglip swaps the head (an
    ArcFace head over 5 classes)."""
    d = _load_yaml(SIGLIP_CARD)
    d.update(target_size=32, bs=16)
    if method == "arcface":
        d["coordination_args"] = dict(ARCFACE)
    elif method != "siglip":
        d["coordination_args"] = {"method": method}
    d["image_encoder_args"].update(
        dropout=0.0, backbone_kwargs={"img_size": 32, "depth": 2})
    d["profile_encoder_args"].update(dim_hidden=64, dim_feedforward=96,
                                     dropout=0.0, target_size=32)
    d["trainer_args"].update(precision=precision,
                             accumulate_grad_batches=every_k)
    return d


def _batch(seed: int, bs: int = 16, img: int = 32, target_size: int = 32):
    """A batch with class ids under ``label`` (the heads other than
    ArcFace never see them: ``MultiModel.loss`` takes the key)."""
    rs = np.random.RandomState(seed)
    lengths = rs.randint(3, target_size + 1, bs)
    lengths[0] = target_size
    tokens = tokenize_transformer(
        [rs.randn(n, 6).astype(np.float32) for n in lengths], target_size,
        pad_to=target_size + 1)
    return {"image": rs.randn(bs, img, img, 1).astype(np.float32),
            "image_shape": rs.randint(200, 400, (bs, 2)).astype(np.int32),
            "profile_len": rs.randint(100, 2000, (bs, 1)).astype(np.int32),
            "label": rs.randint(0, 5, bs).astype(np.int32), **tokens}


@functools.cache
def _jax_run(precision: str, method: str, steps: int = 2):
    """The JAX package's card-built model and train steps on batches 0, 1:
    the initial parameters and (loss, parameters) after each micro-step,
    converted to the port's names."""
    d = _small_card(precision, method)
    card = jax_config.ModelCard.from_dict(copy.deepcopy(d))
    interpret = card.trainer_args.compute_dtype == "bfloat16"
    old = os.environ.get("PLANKTON_FUSED_INTERPRET")
    if interpret:  # bf16 runs the Pallas kernels
        os.environ["PLANKTON_FUSED_INTERPRET"] = "1"
    try:
        model = jax_build_multi_model(card)
        tx = jax_make_optimizer(card.optim_args,
                                card.trainer_args.accumulate_grad_batches)
        batches = [{k: jnp.asarray(v) for k, v in _batch(s).items()}
                   for s in (0, 1)]
        state = jax_create_train_state(model, jax.random.key(0), batches[0],
                                       tx, init_kwargs={
                                           "buckets": card.buckets})
        train_step, _ = jax_make_multi_steps(model, tx, card.buckets)
        init = from_flax({"params": jax.tree.map(np.asarray, state.params)})
        after = []
        for i in range(steps):
            state, loss = train_step(state, batches[i % 2], jax.random.key(1))
            after.append((float(loss), from_flax(
                {"params": jax.tree.map(np.asarray, state.params)})))
    finally:
        if interpret:
            if old is None:
                os.environ.pop("PLANKTON_FUSED_INTERPRET")
            else:
                os.environ["PLANKTON_FUSED_INTERPRET"] = old
    return d, init, after


def _update_errors(init, port_params, jax_params):
    errs = {}
    for name, start in init.items():
        want = (jax_params[name] - start).double()
        got = port_params[name].double() - start.double()
        errs[name] = ((got - want).norm() / want.norm()).item()
    return errs


@pytest.mark.parametrize("precision,method", [
    ("32", "siglip"), ("16-mixed", "siglip"), ("32", "arcface")])
def test_card_train_micro_steps_match_jax(precision, method):
    """``build_multi_model(card)`` + ``make_optimizer(card.optim_args,
    accumulate_grad_batches=2)``: the first micro-step leaves the masters
    as they were, the second updates them as the JAX step does; both
    losses match, and the head's parameters (``logit_bias``; the ArcFace
    ``weight``, fed by the batch's ``label``) move with the rest."""
    d, init, want = _jax_run(precision, method)
    card = config.ModelCard.from_dict(copy.deepcopy(d))
    model = build_multi_model(card)
    tx = make_optimizer(card.optim_args,
                        card.trainer_args.accumulate_grad_batches)
    state = create_train_state(model, init, tx)
    train_step, _ = make_multi_steps(model, tx, step_buckets(card))
    bf16 = precision != "32"
    for step, (jloss, jparams) in enumerate(want, 1):
        batch = {k: torch.from_numpy(v) for k, v in _batch(step - 1).items()}
        state, loss = train_step(state, batch, 0)
        tol = BF16_LOSS_TOL if bf16 else F32_LOSS_TOL
        assert abs(loss.item() - jloss) <= tol * abs(jloss), step
        if step == 1:
            assert all(torch.equal(state.params[n], init[n]) for n in init)
            continue
        errs = _update_errors(init, state.params, jparams)
        worst = max(errs, key=errs.get)
        if bf16:
            assert np.median(list(errs.values())) <= BF16_MEDIAN_TOL
            assert errs[worst] <= BF16_UPDATE_TOL, (worst, errs[worst])
        else:
            assert errs[worst] <= F32_UPDATE_TOL, (worst, errs[worst])
    head = "logit_bias" if method == "siglip" else "weight"
    assert not torch.equal(state.params[f"coordination.{head}"],
                           init[f"coordination.{head}"])
    assert all(m.dtype == torch.float32 for m in state.params.values())


def test_zero_loss_step_applies_weight_decay_only():
    """The zero loss reaches no parameter; the step takes zero gradients, as JAX
    differentiates a constant, so one SGD update (nesterov, first step)
    only decays every master: p · (1 − lr · (1 + momentum) · wd)."""
    card = config.ModelCard.from_dict(_small_card("32", "zero", every_k=1))
    model = build_multi_model(card)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    tx = make_optimizer(card.optim_args)
    state = create_train_state(model, init, tx)
    train_step, _ = make_multi_steps(model, tx, step_buckets(card))
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    state, loss = train_step(state, batch, 0)
    assert loss.item() == 0.0 and loss.dtype == torch.float32
    o = card.optim_args
    decay = 1.0 - o.lr * (1.0 + o.momentum) * o.weight_decay
    for name, start in init.items():
        torch.testing.assert_close(state.params[name], start * decay,
                                   rtol=1e-6, atol=1e-9, msg=name)


class _Recorder:
    """A checkpointer and ``on_epoch_end`` hook that record their calls."""

    def __init__(self):
        self.calls = []

    def save(self, epoch, state, metrics):
        self.calls.append(("save", epoch, sorted(metrics)))

    def wait(self):
        self.calls.append(("wait",))

    def hook(self, epoch, state, metrics):
        self.calls.append(("hook", epoch, sorted(metrics)))


def _fit(fitter_cls, stopper_cls, writer_cls, logdir, to_loss, valid,
         **kwargs):
    """Run a Fitter on scripted steps: train losses drawn from a seeded
    stream, the scripted valid loss of each epoch; returns (history,
    recorded calls, metrics.jsonl records, steps taken)."""
    train = iter(np.random.RandomState(0).rand(1000).astype(np.float32))
    epoch_valid = iter(valid)
    current = {}
    rec = _Recorder()

    def train_step(state, batch, _rng_or_seed):
        return state + 1, to_loss(next(train))

    def eval_step(state, batch):
        if batch["index"][0] == 0:
            current["v"] = next(epoch_valid)
        return {"loss": to_loss(current["v"])}

    writer = writer_cls(logdir)
    fitter = fitter_cls(train_step, eval_step, writer=writer,
                        checkpointer=rec,
                        early_stopping=stopper_cls("valid_loss", "min", 2),
                        hooks={"on_epoch_end": rec.hook}, **kwargs)
    train_loader = [{"index": np.full((4,), i)} for i in range(3)]
    valid_loader = [{"index": np.full((2,), i)} for i in range(2)]
    steps = fitter.fit(0, train_loader, valid_loader)
    writer.close()
    records = [json.loads(line) for line in
               (writer.logdir / "metrics.jsonl").read_text().splitlines()]
    return fitter.history, rec.calls, records, int(steps)


@pytest.mark.parametrize("case", ["stops", "every_2", "nan"])
def test_fitter_matches_jax_fitter(case, tmp_path):
    """Same history keys and values, hook / checkpointer / writer calls,
    and early stopping at the same epoch (patience 2 after min_epochs 3)."""
    valid = {"stops": [5.0, 4.0, 4.5, 4.6, 4.7, 3.0, 3.5, 3.6],
             "every_2": [5.0, 5.5, 5.6, 5.7],
             "nan": [math.nan] * 8}[case]
    kwargs = dict(min_epochs=3, max_epochs=8, seed=3,
                  check_val_every_n_epoch=2 if case == "every_2" else 1)
    want = _fit(JaxFitter, JaxEarlyStopping, JaxMetricsWriter,
                tmp_path / "jax", jnp.float32, valid, **kwargs)
    got = _fit(Fitter, EarlyStopping, MetricsWriter, tmp_path / "port",
               lambda v: torch.tensor(v, dtype=torch.float32), valid,
               **kwargs)
    (hist, calls, records, steps), (jhist, jcalls, jrecords, jsteps) = \
        got, want
    assert steps == jsteps and len(hist) == len(jhist)
    # the stopper sees epochs 2.. (min_epochs 3): stops after 2 bad ones
    assert len(hist) == {"stops": 5, "every_2": 8, "nan": 4}[case]
    assert calls == jcalls
    for row, jrow in zip(hist, jhist):
        assert sorted(row) == sorted(jrow)
        for key in ("train_loss", "valid_loss"):
            if key in jrow:
                np.testing.assert_allclose(row[key], jrow[key], rtol=1e-6)
    assert [sorted(r) for r in records] == [sorted(r) for r in jrecords]
    for row, jrow in zip(records, jrecords):
        for key, value in jrow.items():
            np.testing.assert_allclose(row[key], value, rtol=1e-6)


@functools.cache
def _jax_fused_ffn_run(precision: str):
    """``_jax_run`` for the small card with ``fused_ffn: true`` on both
    encoders, the JAX blocks' FFN on its kernel route (``ffn_core`` in
    interpret mode, as on a TPU; tests/test_torch_ffn.py)."""
    from test_torch_ffn import jax_kernel_route

    d = _small_card(precision)
    for field in ("image_encoder_args", "profile_encoder_args"):
        d[field]["fused_ffn"] = True
    card = jax_config.ModelCard.from_dict(copy.deepcopy(d))
    old = os.environ.get("PLANKTON_FUSED_INTERPRET")
    os.environ["PLANKTON_FUSED_INTERPRET"] = "1"
    try:
        with jax_kernel_route():
            model = jax_build_multi_model(card)
            tx = jax_make_optimizer(card.optim_args,
                                    card.trainer_args.accumulate_grad_batches)
            batches = [{k: jnp.asarray(v) for k, v in _batch(s).items()}
                       for s in (0, 1)]
            state = jax_create_train_state(
                model, jax.random.key(0), batches[0], tx,
                init_kwargs={"buckets": card.buckets})
            train_step, _ = jax_make_multi_steps(model, tx, card.buckets)
            init = from_flax({"params": jax.tree.map(np.asarray,
                                                     state.params)})
            after = []
            for i in range(2):
                state, loss = train_step(state, batches[i],
                                         jax.random.key(1))
                after.append((float(loss), from_flax(
                    {"params": jax.tree.map(np.asarray, state.params)})))
    finally:
        if old is None:
            os.environ.pop("PLANKTON_FUSED_INTERPRET")
        else:
            os.environ["PLANKTON_FUSED_INTERPRET"] = old
    return d, init, after


@pytest.mark.parametrize("precision", ["32", "16-mixed"])
def test_fused_ffn_card_micro_steps_match_jax(precision):
    """The card with ``fused_ffn: true`` on both encoders: two micro-steps
    (accumulation 2) through ``ffn_core`` (its plain versions on the CPU)
    against the JAX step with its FFN on the kernel route: bf16 at the
    bounds of the unfused card, f32 at ``FUSED_F32_*``."""
    d, init, want = _jax_fused_ffn_run(precision)
    card = config.ModelCard.from_dict(copy.deepcopy(d))
    model = build_multi_model(card)
    assert all(b.fused_ffn for b in model.image_encoder.backbone.blocks)
    tx = make_optimizer(card.optim_args,
                        card.trainer_args.accumulate_grad_batches)
    state = create_train_state(model, init, tx)
    train_step, _ = make_multi_steps(model, tx, step_buckets(card))
    bf16 = precision != "32"
    for step, (jloss, jparams) in enumerate(want, 1):
        batch = {k: torch.from_numpy(v) for k, v in _batch(step - 1).items()}
        state, loss = train_step(state, batch, 0)
        tol = BF16_LOSS_TOL if bf16 else F32_LOSS_TOL
        assert abs(loss.item() - jloss) <= tol * abs(jloss), step
    errs = _update_errors(init, state.params, jparams)
    worst = max(errs, key=errs.get)
    median, top = ((BF16_MEDIAN_TOL, BF16_UPDATE_TOL) if bf16 else
                   (FUSED_F32_MEDIAN_TOL, FUSED_F32_UPDATE_TOL))
    assert np.median(list(errs.values())) <= median
    assert errs[worst] <= top, (worst, errs[worst])
