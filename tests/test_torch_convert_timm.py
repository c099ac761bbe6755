"""The port's timm -> npz converter (``models/convert_timm.py``,
``scripts/convert_timm_torch.py``) against the JAX package's
``models/convert_timm.py``, on the CPU, without timm:

* every architecture of ``ARCH_SPECS``: the port's ``synthesize_state_dict``
  (shapes from the port's own backbone through ``convert.to_flax``) is
  JAX's (shapes from ``jax.eval_shape`` of JAX's backbone, nothing
  compiled) key for key and bit for bit; that state dict through both
  packages' ``convert_state_dict`` gives the same params, batch stats and
  ``missing``, and through both ``convert_to_npz`` npz files with the
  same keys, shapes, dtypes and bytes; the inverse layout
  (``to_state_dict``) round-trips the port's trees bit for bit;
* ``load_pretrained_into`` on the port's image classifier of each
  architecture gives JAX's ``loaded`` / ``skipped`` / ``missing`` for
  the same npz, at the default prefix (which loads nothing, as in JAX)
  and at the tree's own (which loads every backbone leaf);
* ``read_torch_file`` on ``.safetensors`` (f32 and bf16) and
  ``torch.save`` files equals the ``safetensors`` package's and
  ``torch.load``'s reading; ``write_safetensors`` files read back through
  the package;
* the layout transforms against torch's op-level oracles, loaded into
  the port's modules (f32, within 1e-5): conv, depthwise conv, dense,
  BatchNorm, the input-channel adaptation, the qkv split and timm's ViT
  attention;
* the CLI: the npz it writes, and ``--selftest`` / ``--from-hub``
  returning 2 without timm.
"""

import copy
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_plankton_recognition_tpu import config as jax_config
from multimodal_plankton_recognition_tpu.models import build as jax_build
from multimodal_plankton_recognition_tpu.models import (
    convert_timm as jax_convert,
)
from multimodal_plankton_recognition_tpu.models import (
    pretrained as jax_pretrained,
)
from multimodal_plankton_recognition_tpu.models.image.registry import (
    create_backbone as jax_backbone,
)
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.convert import from_flax
from multimodal_plankton_recognition_torch.models import build, pretrained
from multimodal_plankton_recognition_torch.models import convert_timm
from multimodal_plankton_recognition_torch.models.attention import (
    FusedSelfAttention,
)
from multimodal_plankton_recognition_torch.models.batchnorm import BatchNorm
from multimodal_plankton_recognition_torch.models.image.registry import (
    create_backbone,
)

from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
ARCHS = sorted(convert_timm.ARCH_SPECS)
NAMES = [f"c{i}" for i in range(3)]
TOL = 1e-5  # f32, of max(1, max |reference|)


def _close(out, ref):
    torch.testing.assert_close(
        out, ref, rtol=TOL, atol=TOL * max(1.0, float(ref.abs().max())))


def _zeros(shapes):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _jax_backbone_trees(arch):
    enc = jax_backbone(arch, in_chans=1)
    variables = _zeros(jax.eval_shape(lambda: enc.init(
        jax.random.key(0), np.zeros((1, 224, 224, 1), np.float32),
        train=False)))
    return variables["params"], variables.get("batch_stats", {})


def _save_torch(sd, path):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
    return path


def _same_arrays(got, want):
    """Same keys in the same order, and each array the same dtype, shape,
    memory order and values (random f32: no zeros, no NaNs, so equal
    values are equal bits)."""
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert (g.dtype, g.shape, g.flags.f_contiguous) == \
            (w.dtype, w.shape, w.flags.f_contiguous), k
        assert np.array_equal(g, w), k


def _same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        _same_arrays({k: x[k] for k in x.files}, {k: y[k] for k in y.files})


def _classifiers(arch):
    """(JAX image classifier variables of zeros, from ``jax.eval_shape``,
    nothing compiled; the port's classifier)."""
    d = {"image_encoder_args": {"name": arch},
         "trainer_args": {"precision": "32"}}
    jmodel = jax_build.build_image_classifier(
        jax_config.ModelCard.from_dict(copy.deepcopy(d)), NAMES)
    variables = _zeros(dict(jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), image=np.zeros((2, 224, 224, 1), np.float32),
        image_shape=np.ones((2, 2), np.int32)))))
    model = build.build_image_classifier(
        config.ModelCard.from_dict(copy.deepcopy(d)), NAMES)
    return variables, model


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_matches_jax(arch, tmp_path):
    """The synthesized state dict, its conversion and npz, and the counts
    of loading that npz, against JAX's, for the image classifier of
    ``arch``."""
    variables, model = _classifiers(arch)
    params = variables["params"][arch]["backbone"]
    stats = variables.get("batch_stats", {}).get(arch, {}).get("backbone",
                                                               {})
    sd = jax_convert.synthesize_state_dict(arch, params, stats)
    # the port's shapes come from its own backbone
    _same_arrays(convert_timm.synthesize_state_dict(
        arch, *convert_timm.backbone_variables(arch)), sd)
    port = convert_timm.convert_state_dict(arch, sd, in_chans=1)
    want = jax_convert.convert_state_dict(arch, sd, in_chans=1)
    _same_arrays(port[0], want[0])
    _same_arrays(port[1], want[1])
    assert port[2] == want[2] == []
    assert set(port[0]) == set(jax_pretrained.flatten_params(params))
    # a truncated file: the same keys missing, the same refusal
    cut = dict(list(sd.items())[3:])
    assert convert_timm.convert_state_dict(arch, cut)[2] == \
        jax_convert.convert_state_dict(arch, cut)[2] != []
    cut_src = _save_torch(cut, tmp_path / "cut.pth")
    with pytest.raises(KeyError) as port_error:
        convert_timm.convert_to_npz(arch, cut_src, tmp_path / "c.npz")
    with pytest.raises(KeyError) as jax_error:
        jax_convert.convert_to_npz(arch, str(cut_src),
                                   str(tmp_path / "c.npz"))
    assert str(port_error.value) == str(jax_error.value)

    src = _save_torch(sd, tmp_path / "w.pth")
    for prefix in ("image_encoder/backbone", f"{arch}/backbone"):
        out = tmp_path / "p.npz"
        counts = convert_timm.convert_to_npz(arch, src, out, prefix=prefix)
        assert counts == jax_convert.convert_to_npz(
            arch, str(src), str(tmp_path / "j.npz"), prefix=prefix)
        _same_npz(out, tmp_path / "j.npz")
        *_, want_counts = jax_pretrained.load_pretrained_npz(
            variables["params"], out,
            batch_stats=variables.get("batch_stats", {}))
        merged, got = pretrained.load_pretrained_into(model, out)
        assert got == want_counts
        n = counts["params"] + counts["batch_stats"]
        if prefix.startswith("image_encoder"):
            # JAX's finding, reproduced: the default prefix names no path
            assert got["loaded"] == 0 and got["skipped"] == n
            continue
        assert got["loaded"] == n and got["skipped"] == 0
        tree = {"params": {arch: {"backbone": pretrained.unflatten_params(
            port[0])}}}
        if port[1]:
            tree["batch_stats"] = {arch: {"backbone":
                                          pretrained.unflatten_params(
                                              port[1])}}
        for name, value in from_flax(tree).items():
            assert torch.equal(merged[name], value), name


@pytest.mark.parametrize("arch", ARCHS)
def test_inverse_layout_round_trips(arch):
    params, stats = convert_timm.backbone_variables(arch)
    gen = np.random.default_rng(3)
    params = jax.tree.map(lambda a: gen.standard_normal(a.shape).astype(
        np.float32), params)
    sd = convert_timm.to_state_dict(arch, params, stats)
    assert list(sd) == list(convert_timm.synthesize_state_dict(arch))
    got_p, got_s, missing = convert_timm.convert_state_dict(arch, sd)
    assert missing == []
    flat_p = pretrained.flatten_params(params)
    flat_s = pretrained.flatten_params(stats)
    assert sorted(got_p) == sorted(flat_p)
    assert sorted(got_s) == sorted(flat_s)
    for got, flat in ((got_p, flat_p), (got_s, flat_s)):
        for k, v in flat.items():
            assert np.array_equal(got[k], v), k


def test_read_torch_file_matches_the_readers(tmp_path):
    safetensors_numpy = pytest.importorskip("safetensors.numpy")
    safetensors_torch = pytest.importorskip("safetensors.torch")
    rs = np.random.default_rng(0)
    f32 = {"a.weight": rs.standard_normal((4, 3, 2, 2)).astype(np.float32),
           "b": rs.standard_normal((7,)).astype(np.float32),
           "n": np.arange(5, dtype=np.int64)}
    path = tmp_path / "f32.safetensors"
    safetensors_numpy.save_file(f32, str(path))
    got = convert_timm.read_torch_file(path)
    _same_arrays(dict(sorted(got.items())),
                 dict(sorted(safetensors_numpy.load_file(str(path)).items())))
    _same_arrays(dict(sorted(got.items())),
                 dict(sorted(jax_convert.read_torch_file(str(path)).items())))

    bf16 = {k: torch.from_numpy(v).to(torch.bfloat16)
            for k, v in f32.items() if v.dtype == np.float32}
    path = tmp_path / "bf16.safetensors"
    safetensors_torch.save_file(bf16, str(path))
    got = convert_timm.read_torch_file(path)
    want = safetensors_torch.load_file(str(path))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        assert np.array_equal(got[k], v.float().numpy()), k

    path = tmp_path / "w.pth"
    torch.save({"state_dict": {**{k: torch.from_numpy(v)
                                  for k, v in f32.items()},
                               "h": bf16["b"]}}, path)
    got = convert_timm.read_torch_file(path)
    want = torch.load(path, weights_only=True)["state_dict"]
    assert list(got) == list(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v.float().numpy()
                              if v.dtype == torch.bfloat16 else v.numpy())

    path = tmp_path / "port.safetensors"
    convert_timm.write_safetensors(f32, path)
    _same_arrays(safetensors_numpy.load_file(str(path)), f32)
    _same_arrays(convert_timm.read_torch_file(path), f32)


def _arange(shape):
    """Every element distinct, so a transposed layout shows."""
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.float32).reshape(shape) - n / 2) / n


def _convert(monkeypatch, specs, sd):
    monkeypatch.setitem(convert_timm.ARCH_SPECS, "mini", lambda: specs)
    params, stats, missing = convert_timm.convert_state_dict("mini", sd)
    assert missing == []
    tree = {"params": pretrained.unflatten_params(params)}
    if stats:
        tree["batch_stats"] = pretrained.unflatten_params(stats)
    return from_flax(tree)


class _Mini(torch.nn.Module):
    def __init__(self, kind, c):
        super().__init__()
        if kind == "conv":
            self.m = torch.nn.Conv2d(3, 8, 3, stride=2, bias=False)
        elif kind == "dwconv":
            self.m = torch.nn.Conv2d(c, c, 3, padding=1, groups=c,
                                     bias=False)
        elif kind == "dense":
            self.m = torch.nn.Linear(7, 5)
        else:
            self.m = BatchNorm(c)


@pytest.mark.parametrize("kind", ["conv", "dwconv", "dense", "bn"])
def test_direction_matches_torch(kind, monkeypatch):
    """Each layout transform, loaded into a port module through
    ``from_flax``, computes what torch's op computes on the timm weights
    (the port's BatchNorm in eval mode on the running statistics)."""
    c = 6
    rs = np.random.default_rng(1)
    if kind == "conv":
        w = _arange((8, 3, 3, 3))
        sd, specs = {"c.weight": w}, [("conv", "c.weight", "m/kernel")]
        x = rs.standard_normal((2, 3, 9, 9)).astype(np.float32)
        ref = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=2)
    elif kind == "dwconv":
        w = _arange((c, 1, 3, 3))
        sd, specs = {"c.weight": w}, [("dwconv", "c.weight", "m/kernel")]
        x = rs.standard_normal((2, c, 8, 8)).astype(np.float32)
        ref = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), groups=c,
                       padding=1)
    elif kind == "dense":
        w, b = _arange((5, 7)), _arange((5,))
        sd, specs = {"d.weight": w, "d.bias": b}, [("dense", "d", "m")]
        x = rs.standard_normal((3, 7)).astype(np.float32)
        ref = F.linear(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b))
    else:
        stats = {"weight": _arange((c,)) + 1.0, "bias": _arange((c,)),
                 "running_mean": _arange((c,)) * 2.0,
                 "running_var": np.abs(_arange((c,))) + 0.5}
        sd = {f"n.{k}": v for k, v in stats.items()}
        specs = [("bn", "n", "m")]
        x = rs.standard_normal((2, c, 4, 4)).astype(np.float32)
        ref = F.batch_norm(torch.from_numpy(x),
                           *(torch.from_numpy(stats[k]) for k in (
                               "running_mean", "running_var", "weight",
                               "bias")), training=False, eps=1e-5)
    module = _Mini(kind, c)
    module.load_state_dict(_convert(monkeypatch, specs, sd), strict=True)
    with torch.no_grad():
        out = module.eval().m(torch.from_numpy(x))
    _close(out, ref)


@pytest.mark.parametrize("src,dst", [(3, 1), (1, 3), (3, 3)])
def test_adapt_in_chans(src, dst):
    """timm's ``adapt_input_conv``: the adapted kernel on a grey (or
    single-channel) image is the source kernel on its channels repeated
    (summed for one channel, averaged over a repeat for three); equal to
    JAX's."""
    w = _arange((4, src, 3, 3))
    got = convert_timm._adapt_in_chans(w, dst)
    np.testing.assert_array_equal(got, jax_convert._adapt_in_chans(w, dst))
    g = np.random.default_rng(6).standard_normal(
        (2, 1, 8, 8)).astype(np.float32)
    if src == 3 and dst == 1:
        ref = F.conv2d(torch.from_numpy(np.repeat(g, 3, axis=1)),
                       torch.from_numpy(w))
        out = F.conv2d(torch.from_numpy(g), torch.from_numpy(got))
    else:
        x = np.repeat(g, dst, axis=1)
        ref = F.conv2d(torch.from_numpy(g if src == 1 else x),
                       torch.from_numpy(w))
        out = F.conv2d(torch.from_numpy(x), torch.from_numpy(got))
    _close(out, ref)
    with pytest.raises(ValueError, match="cannot adapt"):
        convert_timm._adapt_in_chans(_arange((4, 2, 3, 3)), 3)


def _timm_attention(x, w_qkv, b_qkv, w_proj, b_proj, h):
    """timm's ``vision_transformer.Attention.forward``."""
    b, n, d = x.shape
    qkv = F.linear(x, w_qkv, b_qkv).reshape(b, n, 3, h, d // h)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    attn = torch.softmax(q @ k.transpose(-2, -1) * (d // h) ** -0.5, dim=-1)
    return F.linear((attn @ v).transpose(1, 2).reshape(b, n, d), w_proj,
                    b_proj)


def test_attention_matches_timm_math(monkeypatch):
    """The qkv row split, the (D, h, hd) kernels and the (h, hd, D) out
    projection: timm's attention on the timm weights equals the port's
    ``FusedSelfAttention`` holding the converted ones (both its packed
    route and flax's attention)."""
    d, h = 16, 4
    w = {"qkv.weight": _arange((3 * d, d)), "qkv.bias": _arange((3 * d,)),
         "proj.weight": _arange((d, d)) * 0.3, "proj.bias": _arange((d,))}
    sd = _convert(monkeypatch, [("qkv", "qkv", "attn", h),
                                ("attn_out", "proj", "attn/out", h)], w)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 6, d)).astype(np.float32))
    ref = _timm_attention(x, *(torch.from_numpy(w[k]) for k in (
        "qkv.weight", "qkv.bias", "proj.weight", "proj.bias")), h)
    for fused in (True, False):
        attn = FusedSelfAttention(d, h, fused=fused)
        attn.load_state_dict({k[len("attn."):]: v for k, v in sd.items()},
                             strict=True)
        with torch.no_grad():
            _close(attn.eval()(x), ref)


def test_vit_spec_matches_timm_math():
    """The shipped ``_spec_vit`` rules (not a copy): block 0 of the port's
    ViT-T loaded through the converter computes timm's attention, and its
    q is timm's ``qkv[:D]`` projection."""
    arch, d, h = "vit_tiny_patch16_224", 192, 3
    sd = convert_timm.synthesize_state_dict(arch)
    sd["blocks.0.attn.qkv.weight"] = _arange((3 * d, d))
    sd["blocks.0.attn.qkv.bias"] = _arange((3 * d,))
    sd["blocks.0.attn.proj.weight"] = _arange((d, d)) * 0.3
    params, _, _ = convert_timm.convert_state_dict(arch, sd)
    vit = create_backbone(arch, in_chans=1)
    vit.load_state_dict(from_flax(
        {"params": pretrained.unflatten_params(params)}), strict=True)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 5, d)).astype(np.float32))
    ref = _timm_attention(x, *(torch.from_numpy(sd[f"blocks.0.attn.{k}"])
                               for k in ("qkv.weight", "qkv.bias",
                                         "proj.weight", "proj.bias")), h)
    with torch.no_grad():
        _close(vit.blocks[0].attn.eval()(x), ref)
    wq = params["block_0/attn/query/kernel"].reshape(d, d)
    bq = params["block_0/attn/query/bias"].reshape(d)
    xq = x[0].numpy()
    _close(torch.from_numpy(xq @ wq + bq),
           torch.from_numpy(xq @ sd["blocks.0.attn.qkv.weight"][:d].T
                            + sd["blocks.0.attn.qkv.bias"][:d]))


def _cli():
    spec = importlib.util.spec_from_file_location(
        "convert_timm_torch", REPO / "scripts" / "convert_timm_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_cli_writes_the_npz(tmp_path, capsys, monkeypatch):
    cli = _cli()
    arch = "resnet18"
    sd = convert_timm.synthesize_state_dict(arch)
    src = tmp_path / "w.safetensors"
    convert_timm.write_safetensors(sd, src)
    out = tmp_path / "cli.npz"
    assert cli.main(["-a", arch, "-i", str(src), "-o", str(out),
                     "--prefix", f"{arch}/backbone"]) == 0
    printed = capsys.readouterr().out
    assert printed == f"wrote {out}: 60 params + 40 batch_stats arrays\n"
    jax_convert.convert_to_npz(arch, str(_save_torch(sd, tmp_path / "w.pth")),
                               str(tmp_path / "jax.npz"),
                               prefix=f"{arch}/backbone")
    _same_npz(out, tmp_path / "jax.npz")
    # no timm here: both timm paths say why and exit 2
    monkeypatch.setitem(sys.modules, "timm", None)
    assert cli.main(["--selftest", "-a", arch, "--device", "cpu"]) == 2
    assert "run this where timm is installed" in capsys.readouterr().out
    assert cli.main(["--from-hub", "-a", arch, "-o", str(out),
                     "--device", "cpu"]) == 2
    assert "pip install timm && python scripts/convert_timm_torch.py" \
        in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["-a", arch])
