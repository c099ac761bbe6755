"""The serving export of the port (``retrieval/export.py``) against the
JAX package's (``jax.export``), and the registered ops that keep the
kernels in an exported program.

Same inputs on both sides: a small ViT card (32 px, 2 blocks 48 wide)
with the profile CNN, LSTM or transformer of ``tests/test_export.py``,
JAX's variables from ``model.init`` carried into the port by
``convert.from_flax``, batches from a seeded numpy generator.

Tolerances: the port's stripped artifact against JAX's artifact and the
classifier's logits within 1e-5 abs and rel (``tests/test_export.py``
holds JAX's artifact to its own ``apply`` so); the port's artifact against
the port's eager model bit for bit (the program runs the same ATen ops);
the retrieval artifact's classes equal JAX's and the hand-composed
``ANNClassifier.predict``'s, its votes within 1e-6 relative;
``weighted_mode_device`` and ``inverse_distance_weights`` exact.
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
from multimodal_plankton_recognition_tpu.ops import knn as jax_knn
from multimodal_plankton_recognition_tpu.retrieval import export as jax_ex
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.convert import from_flax
from multimodal_plankton_recognition_torch.models.build import build_for_kind
from multimodal_plankton_recognition_torch.ops import knn
from multimodal_plankton_recognition_torch.ops.losses import l2_normalize
from multimodal_plankton_recognition_torch.retrieval import export as ex
from multimodal_plankton_recognition_torch.train.checkpoint import (
    CheckpointManager,
)
from torch_threads import one_thread  # noqa: F401

TOL = 1e-5
VOTE_RTOL = 1e-6
TS = 32
TRACED = ex.TRACE_BATCH


def _card_dict(profile_kind="cnn", precision="32", image="resnet18"):
    pe = {"kind": profile_kind, "dim_in": 6}
    if profile_kind == "cnn":
        pe.update(blocks=[1, 1, 1, 1], base_channels=8)
    elif profile_kind == "transformer":
        pe.update(dim_hidden=16, num_head=2, num_layers=1, target_size=TS)
    else:
        pe.update(dim_hidden=16, num_layers=1)
    ie = {"name": "resnet18", "metadata": True}
    if image == "vit":
        ie = {"name": "vit_tiny_patch16_224", "in_chans": 1,
              "metadata": True, "fused_attention": True, "dropout": 0.0,
              "backbone_kwargs": {"img_size": TS, "depth": 2,
                                  "embed_dim": 48, "num_heads": 3}}
        if profile_kind == "transformer":
            pe.update(fused_attention=True, dim_hidden=64, num_head=4,
                      num_layers=2, dim_feedforward=96, dropout=0.0)
    return {"bs": 4, "dim_embedding": 16, "target_size": TS,
            "image_encoder_args": ie, "profile_encoder_args": pe,
            "coordination_args": {"method": "clip"},
            "trainer_args": {"precision": precision}}


def _batch(card, kind, b, seed=0):
    """``tests/test_export.py``'s batch: normal floats, no padding, random
    integers, full-length time indices."""
    rng = np.random.default_rng(seed)
    batch = {}
    for key, (shape, dtype) in ex.batch_spec(card, kind).items():
        shape = tuple(b if d is None else d for d in shape)
        if dtype == "float32":
            batch[key] = rng.normal(size=shape).astype(np.float32)
        elif dtype == "bool":
            batch[key] = np.zeros(shape, dtype=bool)
        elif key == "last_idx":
            batch[key] = np.full(shape, shape and 5, dtype=np.int32)
        elif key == "time":
            batch[key] = np.tile(np.arange(shape[1], dtype=np.int32), (b, 1))
        else:
            batch[key] = rng.integers(1, 30, size=shape).astype(np.int32)
    return batch


def _jax_pair(d, kind="multi", classes=("a", "b", "c")):
    """(JAX card, model, variables; port card, model) on the same weights,
    both with the kernel flags stripped as the exports strip them."""
    jcard = jax_ex._strip_fused(jax_config.ModelCard.from_dict(
        copy.deepcopy(d)))
    if kind == "multi":
        jmodel = jax_build.build_multi_model(jcard)
    elif kind == "image":
        jmodel = jax_build.build_image_classifier(jcard, list(classes))
    else:
        jmodel = jax_build.build_profile_classifier(jcard, list(classes))
    arrays = {k: jnp.asarray(v) for k, v in _batch(jcard, kind, 2).items()}
    extra = {"method": "encode"} if kind == "multi" else {}
    variables = jax.jit(functools.partial(jmodel.init, train=False,
                                          **extra))(jax.random.PRNGKey(0),
                                                    **arrays)
    card = ex._strip_fused(config.ModelCard.from_dict(copy.deepcopy(d)))
    model = build_for_kind(card, kind, classes)
    missing, unexpected = model.load_state_dict(
        from_flax(jax.tree.map(np.asarray, variables)), strict=False)
    # JAX's ``encode`` init makes no coordination head, which no
    # inference function reads
    assert not unexpected and all(n.startswith("coordination.")
                                  for n in missing), (missing, unexpected)
    return jcard, jmodel, variables, card, model.eval()


def _eager(model, kind, batch):
    with torch.no_grad():
        inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
        if kind == "multi":
            emb = model.encode(**inputs)
            return {k: l2_normalize(emb[k]).float().numpy()
                    for k in ("image_emb", "profile_emb")}
        return {"logits": model(**inputs).float().numpy()}


def _run(program, batch):
    if not hasattr(program, "_module"):
        program._module = program.module()
    with torch.no_grad():
        out = program._module(**{k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.mark.parametrize("profile_kind", ["cnn", "lstm", "transformer"])
def test_multi_artifact_matches_jax_and_eager(profile_kind):
    """The stripped ``multi`` program of the small ViT with a profile CNN,
    LSTM or transformer against JAX's artifact on the same weights (1e-5)
    and against the port's eager encode (bit for bit), at batch 1, 3 and
    the traced size; one symbolic program serves all."""
    d = _card_dict(profile_kind, image="vit")
    jcard, jmodel, variables, card, model = _jax_pair(d)
    exported = jax_ex.export_inference(jmodel, variables, jcard, "multi",
                                       platforms=("cpu",))
    program = ex.export_inference(model, card, "multi",
                                  platforms=("cpu",))["cpu"]
    for b in sorted({1, 3, TRACED}):
        batch = _batch(card, "multi", b, seed=b)
        got = _run(program, batch)
        want = exported.call({k: jnp.asarray(v) for k, v in batch.items()})
        eager = _eager(model, "multi", batch)
        for key in ("image_emb", "profile_emb"):
            assert got[key].shape == (b, 16)
            np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                       rtol=TOL, atol=TOL, err_msg=key)
            np.testing.assert_array_equal(got[key], eager[key])


@pytest.mark.parametrize("kind", ["profile"])
def test_classifier_artifact_logits_match_jax(kind):
    d = dict(_card_dict("transformer"), max_len=TS)
    jcard, jmodel, variables, card, model = _jax_pair(d, kind)
    exported = jax_ex.export_inference(jmodel, variables, jcard, kind,
                                       platforms=("cpu",))
    program = ex.export_inference(model, card, kind,
                                  platforms=("cpu",))["cpu"]
    for b in (1, 4):
        batch = _batch(card, kind, b, seed=b)
        got = _run(program, batch)["logits"]
        want = np.asarray(exported.call(
            {k: jnp.asarray(v) for k, v in batch.items()})["logits"])
        assert got.shape == (b, 3)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got, _eager(model, kind,
                                                  batch)["logits"])


@pytest.mark.parametrize("kind", ["multi", "image", "profile"])
@pytest.mark.parametrize("profile_kind", ["cnn", "transformer", "lstm"])
def test_input_spec_is_jax_batch_spec(kind, profile_kind):
    d = _card_dict(profile_kind)
    jcard = jax_config.ModelCard.from_dict(copy.deepcopy(d))
    card = config.ModelCard.from_dict(copy.deepcopy(d))
    assert ex.batch_spec(card, kind) == jax_ex.batch_spec(jcard, kind)


def _save_checkpoint(root, d, kind="multi", classes=("a", "b", "c"),
                     seed=0):
    """A port checkpoint of the card ``d``: seeded random f32 masters."""
    from multimodal_plankton_recognition_torch.models.initializers import (
        init_weights_,
    )
    from multimodal_plankton_recognition_torch.train import (
        create_train_state, make_optimizer,
    )

    card = config.ModelCard.from_dict(copy.deepcopy(d))
    init = init_weights_(
        build_for_kind(card, kind, classes, dtype=torch.float32),
        torch.Generator().manual_seed(seed)).state_dict()
    tx = make_optimizer(card.optim_args, 1)
    state = create_train_state(build_for_kind(card, kind, classes), init,
                               tx)
    mngr = CheckpointManager(root, metadata={
        "card": card.to_dict(), "kind": kind, "class_names": list(classes)})
    assert mngr.save(0, state, {"valid_loss": 1.0})
    mngr.wait()
    return root


def test_export_checkpoint_round_trip(tmp_path):
    """``export_checkpoint`` → ``load_artifact(device="cpu")``: JAX's
    metadata keys (``torch_version`` for ``jax_version``), one program per
    platform, bit for bit the stripped eager model; wrong keys raise
    JAX's message; a platform the artifact lacks raises; the caller's
    card is not mutated."""
    d = _card_dict("transformer", image="vit", precision="16-mixed")
    ckpt = _save_checkpoint(tmp_path / "ckpt", d)
    card = config.ModelCard.from_dict(copy.deepcopy(d))
    before = card.to_dict()
    stripped = ex._strip_fused(card)
    assert card.to_dict() == before
    assert "fused_attention" not in stripped.image_encoder_args
    art = ex.export_checkpoint(ckpt, tmp_path / "art", platforms=("cpu",))
    assert sorted(p.name for p in art.iterdir()) == ["metadata.json",
                                                     "model.cpu.pt2"]
    serving = ex.load_artifact(art, device="cpu")
    meta = serving.meta
    assert sorted(meta) == sorted(["kind", "classes", "input_spec",
                                   "outputs", "platforms", "batch_size",
                                   "torch_version", "card"])
    assert meta["kind"] == "multi" and meta["platforms"] == ["cpu"]
    assert meta["batch_size"] == "symbolic"
    assert meta["card"] == stripped.to_dict()
    assert list(serving.classes) == ["a", "b", "c"]
    from multimodal_plankton_recognition_torch.train.checkpoint import (
        load_from_checkpoint,
    )
    model, _, _ = load_from_checkpoint(ckpt, device="cpu")
    eager = build_for_kind(stripped, "multi", ())
    eager.load_state_dict(model.state_dict())
    for b in (1, 4):
        batch = _batch(card, "multi", b, seed=b)
        got = serving.call(batch)
        want = _eager(eager.eval(), "multi", batch)
        for key in ("image_emb", "profile_emb"):
            np.testing.assert_array_equal(got[key],
                                          want[key].astype(np.float32))
    bad = dict(_batch(card, "multi", 2), extra=np.zeros((2,), np.int32))
    with pytest.raises(ValueError, match="Batch keys .* != artifact inputs"):
        serving.call(bad)
    import json
    meta["platforms"] = ["cuda"]  # as if exported for the card alone
    (art / "metadata.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="has no cpu program"):
        ex.load_artifact(art, device="cpu")


def test_cuda_platform_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = _card_dict("cnn")
    card = config.ModelCard.from_dict(d)
    model = build_for_kind(card, "multi")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ex.export_inference(model, card, "multi")
    with pytest.raises(ValueError, match="platforms must be among"):
        ex.export_inference(model, card, "multi", platforms=("tpu",))


def test_pinned_batch_size():
    d = _card_dict("lstm", image="vit")
    card = config.ModelCard.from_dict(d)
    model = build_for_kind(card, "multi")
    program = ex.export_inference(model, card, "multi", platforms=("cpu",),
                                  batch_size=4)["cpu"]
    assert _run(program, _batch(card, "multi", 4))["image_emb"].shape == \
        (4, 16)
    with pytest.raises(Exception):
        _run(program, _batch(card, "multi", 3))


# --- retrieval ------------------------------------------------------------


def test_weighted_mode_device_and_weights_match_jax():
    rng = np.random.default_rng(0)
    classes = rng.integers(0, 5, (64, 18)).astype(np.int32)
    weights = rng.random((64, 18)).astype(np.float32)
    weights[3] = 1.0  # ties: the smaller id wins on both sides
    got_id, got_votes = knn.weighted_mode_device(
        torch.from_numpy(classes), torch.from_numpy(weights), 5)
    want_id, want_votes = jax_knn.weighted_mode_device(
        jnp.asarray(classes), jnp.asarray(weights), 5)
    np.testing.assert_array_equal(got_id.numpy(), np.asarray(want_id))
    np.testing.assert_allclose(got_votes.numpy(), np.asarray(want_votes),
                               rtol=VOTE_RTOL, atol=0)
    dist = rng.random((64, 18)).astype(np.float32)
    dist[5, 3] = 0.0
    dist[7, [1, 4]] = 5e-5
    for eps in (0.0, 1e-4):
        got = knn.inverse_distance_weights(torch.from_numpy(dist),
                                           exact_eps=eps).numpy()
        want = np.asarray(jax_knn.inverse_distance_weights(
            jnp.asarray(dist), exact_eps=eps))
        np.testing.assert_array_equal(got, want)
    assert (knn.inverse_distance_weights(torch.from_numpy(dist))
            == knn.inverse_distance_weights(torch.from_numpy(dist),
                                            exact_eps=0.0)).all()


def test_retrieval_artifact_matches_jax_and_ann():
    """The retrieval program (gallery: the port's own embeddings of 24
    pairs over 3 classes, fused) against JAX's retrieval artifact on the
    same weights and gallery, and against the eager encode composed with
    ``ANNClassifier(fused gallery, tiled labels).predict`` by hand. Fresh
    queries: classes equal, votes within 1e-6 relative; gallery members
    as queries: the exact-hit rule fires, every row its own label."""
    d = _card_dict("transformer", image="vit")
    jcard, jmodel, variables, card, model = _jax_pair(d)
    rng = np.random.default_rng(5)
    gal = _batch(card, "multi", 24, seed=11)
    emb = _eager(model, "multi", gal)
    labels = rng.integers(0, 3, 24).astype(np.int32)
    k = 3
    programs = ex.export_retrieval_inference(
        model, card, emb["image_emb"], emb["profile_emb"], labels, 3, k=k,
        platforms=("cpu",))
    exported = jax_ex.export_retrieval_inference(
        jmodel, variables, jcard, emb["image_emb"], emb["profile_emb"],
        labels, 3, k=k, platforms=("cpu",))
    program = programs["cpu"]
    ann = knn.ANNClassifier(
        np.concatenate([emb["image_emb"], emb["profile_emb"]]),
        np.tile(labels, 2), device="cpu")
    for b, seed in ((5, 21), (1, 22)):
        q = _batch(card, "multi", b, seed=seed)
        got = _run(program, q)
        want = exported.call({kk: jnp.asarray(v) for kk, v in q.items()})
        np.testing.assert_array_equal(got["class_id"],
                                      np.asarray(want["class_id"]))
        np.testing.assert_allclose(got["votes"], np.asarray(want["votes"]),
                                   rtol=VOTE_RTOL, atol=0)
        e = _eager(model, "multi", q)
        np.testing.assert_array_equal(
            got["class_id"], ann.predict(e["image_emb"], e["profile_emb"],
                                         k=k))
    got = _run(program, gal)
    np.testing.assert_array_equal(got["class_id"], labels)
    # exact hits: all the mass on the zero-distance neighbours
    assert np.all(got["votes"].max(axis=1) >= 2.0)
    np.testing.assert_array_equal(
        got["class_id"], np.asarray(exported.call(
            {kk: jnp.asarray(v) for kk, v in gal.items()})["class_id"]))


# --- --keep-fused: the kernels as registered ops ---------------------------


def _ops(program):
    return sorted({str(n.target) for n in program.graph.nodes
                   if str(n.target).startswith("plankton.")})


@pytest.mark.parametrize("route,env,ffn,want", [
    ("packed", {}, False, ["plankton.mha_qkv_fwd.default"]),
    ("fused_ffn", {}, True, ["plankton.ffn_fwd.default",
                             "plankton.mha_qkv_fwd.default"]),
    ("unpacked", {"PLANKTON_ATTN_QKV_PACKED": "0"}, False,
     ["plankton.mha_fwd.default"]),
    ("fuse_proj", {"PLANKTON_ATTN_FUSE_PROJ": "1"}, False,
     ["plankton.attn_block_fwd.default"]),
])
def test_keep_fused_keeps_the_kernels_as_ops(route, env, ffn, want,
                                             monkeypatch, tmp_path):
    """A bf16 ViT card exported with ``keep_fused``: the program holds the
    registered op of each kernel its route reaches (kernel 1 on the
    packed route, 9 under ``fused_ffn``, 3 and 11 under the two attention
    switches) and no plain attention math; run on the CPU it equals the
    eager kernel-route model bit for bit. The packed route goes through
    the checkpoint, ``save`` and ``load``, and its stripped export holds
    no op."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    d = _card_dict("transformer", image="vit", precision="16-mixed")
    if ffn:
        d["image_encoder_args"]["fused_ffn"] = True
        d["profile_encoder_args"]["fused_ffn"] = True
    ckpt = _save_checkpoint(tmp_path / "ckpt", d)
    from multimodal_plankton_recognition_torch.train.checkpoint import (
        load_from_checkpoint,
    )
    model, _, _ = load_from_checkpoint(ckpt, device="cpu")
    card = config.ModelCard.from_dict(d)
    if route == "packed":
        art = ex.export_checkpoint(ckpt, tmp_path / "art",
                                   platforms=("cpu",), keep_fused=True)
        serving = ex.load_artifact(art, device="cpu")
        program, call = serving.program, serving.call
        stripped = ex.export_checkpoint(ckpt, tmp_path / "stripped",
                                        platforms=("cpu",))
        assert _ops(ex.load_artifact(stripped, device="cpu").program) == []
    else:
        program = ex.export_inference(model, card, "multi",
                                      platforms=("cpu",))["cpu"]
        call = functools.partial(_run, program)
    assert _ops(program) == want
    for b in (1, 3):
        batch = _batch(card, "multi", b, seed=b)
        batch["padding_mask"][:, 20:] = True
        got = call(batch)
        eager = _eager(model.eval(), "multi", batch)
        for key in ("image_emb", "profile_emb"):
            np.testing.assert_array_equal(got[key], eager[key])


def test_wrappers_reach_the_ops_only_without_a_gradient(monkeypatch):
    """Eval (no gradient) goes through the registered op; a train forward
    keeps the ``autograd.Function`` and its backward."""
    from multimodal_plankton_recognition_torch.ops import attention

    calls = []
    real = torch.ops.plankton.mha_qkv_fwd
    monkeypatch.setattr(attention, "mha_qkv_fwd_op",
                        lambda *a: calls.append(1) or real(*a))
    qkv = torch.randn(2, 5, 48).bfloat16()
    with torch.no_grad():
        attention.mha_qkv(qkv, None, 2)
    attention.mha_qkv(qkv, None, 2)  # no input needs a gradient
    assert calls == [1, 1]
    x = qkv.clone().requires_grad_()
    attention.mha_qkv(x, None, 2).float().sum().backward()
    assert calls == [1, 1] and x.grad is not None
