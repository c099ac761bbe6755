"""The EfficientNet-B0 family's modules against the Flax modules of the JAX
package, on weights converted by ``convert.py`` (batch_stats included):
Flax BatchNorm / GroupNorm, ``EfficientNet`` and ``ProfileCNN`` in f32 in
eval and train mode, the route each MBConv block takes, and the weight
bridge's B0 and CNN rules. The bf16 fused modules are in
``tests/test_torch_b0_fused.py``.

Tolerances, of max(1, max|·|) of the JAX value: features and the updated
running statistics to 1e-4 in f32. The f32 train case runs B 16 at 24×24:
at B 4 B0's last blocks normalize 4 values per channel, and f32 rounding
alone moves the features past 1e-4 there, in either framework.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from multimodal_plankton_recognition_tpu.models.image.efficientnet import (
    EfficientNet as JaxEfficientNet,
)
from multimodal_plankton_recognition_tpu.models.profile.cnn import (
    ProfileCNN as JaxProfileCNN,
)
from multimodal_plankton_recognition_torch.convert import from_flax
from multimodal_plankton_recognition_torch.models import batchnorm
from multimodal_plankton_recognition_torch.models.image import efficientnet
from multimodal_plankton_recognition_torch.models.image.efficientnet import (
    EfficientNet,
)
from multimodal_plankton_recognition_torch.models.profile.cnn import (
    ProfileCNN,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

F32_TOL = 1e-4


def _np(tree):
    """A Flax tree as numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want,
                               atol=tol * max(1.0, np.abs(want).max()),
                               rtol=0, err_msg=what)


def _random_stats(variables, seed):
    """The tree with random running statistics (means around 0, variances
    in [0.5, 1.5]), so eval mode normalizes with something other than the
    init's 0 / 1."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key == "mean":
            return (0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        return (0.5 + rs.rand(*leaf.shape)).astype(np.float32)

    return {"params": variables["params"], "batch_stats":
            jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])}


def _stats_close(module, updated, tol):
    """The module's buffers against a Flax ``batch_stats`` tree."""
    want = from_flax({"params": {}, "batch_stats": _np(updated)})
    got = dict(module.named_buffers())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32, name
        _close(got[name].numpy(), w.numpy(), tol, name)


# ------------------------------- the norms -------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches_flax(train):
    """Batch statistics (biased variance), momentum 0.99, eps 1e-5 and the
    f32 statistics of a bf16 input, as ``flax.linen.BatchNorm``."""
    rs = np.random.RandomState(0)
    x = (3.0 + 2.0 * rs.randn(6, 5, 4, 7)).astype(np.float32)
    variables = {"params": {"scale": 1 + 0.1 * rs.randn(7),
                            "bias": 0.1 * rs.randn(7)},
                 "batch_stats": {"mean": rs.randn(7),
                                 "var": 0.5 + rs.rand(7)}}
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32), variables)
    flax_bn = fnn.BatchNorm(use_running_average=not train,
                            dtype=jnp.bfloat16)
    want, upd = flax_bn.apply(variables, jnp.asarray(x, jnp.bfloat16),
                              mutable=["batch_stats"])
    bn = batchnorm.BatchNorm(7)
    bn.load_state_dict(from_flax(variables))
    bn.to(torch.bfloat16).train(train)
    got = bn(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    _close(got.permute(0, 2, 3, 1), want, 1e-2)
    want_stats = upd["batch_stats"] if train else variables["batch_stats"]
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        buf = getattr(bn, name)
        assert buf.dtype == torch.float32
        _close(buf.numpy(), want_stats[key], 1e-6, name)


def test_groupnorm_matches_flax():
    rs = np.random.RandomState(1)
    x = (1.0 + rs.randn(3, 10, 16)).astype(np.float32)
    variables = {"params": {"scale": (1 + 0.1 * rs.randn(16)),
                            "bias": 0.1 * rs.randn(16)}}
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32), variables)
    want = fnn.GroupNorm(num_groups=None, group_size=8).apply(
        variables, jnp.asarray(x))
    gn = batchnorm.GroupNorm(16, group_size=8)
    gn.load_state_dict(from_flax(variables))
    got = gn(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    _close(got.detach().numpy(), want, 1e-5)


def test_norms_stay_f32_through_a_bf16_cast():
    """``MultiModel`` casts its encoders with ``module.to(dtype)``: the
    norms' scales, biases and running statistics stay f32, convolutions
    take the dtype."""
    net = EfficientNet(in_chans=1)
    with torch.no_grad():  # not a bf16 value: a cast must not round it
        net.head_bn.running_var.fill_(1 / 3)
    net.to(torch.bfloat16)
    assert net.head_bn.running_var[0].item() == torch.tensor(1 / 3).item()
    cnn = ProfileCNN(blocks=(1, 1, 1, 1), base_channels=8).to(torch.bfloat16)
    for module in (net, cnn):
        for name, t in (*module.named_parameters(),
                        *module.named_buffers()):
            want = torch.float32 if "bn" in name else torch.bfloat16
            assert t.dtype == want, name


# ----------------------------- EfficientNet ------------------------------

@pytest.fixture(scope="module")
def b0_variables():
    """A B0 tree (params + batch_stats) from the Flax initialisers; the
    fused and unfused Flax modules declare the same tree."""
    net = JaxEfficientNet(in_chans=1, dtype=jnp.float32)
    x = jnp.zeros((1, 8, 8, 1))
    init = jax.jit(lambda key: net.init(key, x, train=False))
    return _np(init(jax.random.key(0)))


def _port_b0(variables, dtype=torch.float32, fused=False):
    net = EfficientNet(in_chans=1, fused=fused)
    net.load_state_dict(from_flax(variables), strict=True)
    return net.to(dtype)


@pytest.mark.parametrize("train", [False, True])
def test_efficientnet_f32_matches_flax(b0_variables, train):
    variables = _random_stats(b0_variables, 1) if not train else b0_variables
    bs = 16 if train else 4
    x = np.random.RandomState(2).randn(bs, 24, 24, 1).astype(np.float32)
    jnet = JaxEfficientNet(in_chans=1, dtype=jnp.float32)
    # one compile (op-by-op, B0's forward took most of this file's time)
    want, upd = jax.jit(lambda v, x: jnet.apply(
        v, x, train=train, mutable=["batch_stats"]))(variables,
                                                     jnp.asarray(x))
    net = _port_b0(variables).train(train)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (bs, 1280) and got.dtype == torch.float32
    _close(got.numpy(), want, F32_TOL, "features")
    _stats_close(net, upd["batch_stats"] if train
                 else variables["batch_stats"], F32_TOL)


@pytest.mark.parametrize("dtype,train,fused,calls", [
    (torch.bfloat16, True, True, 12),    # the 12 stride-1 blocks
    (torch.bfloat16, False, True, 0),    # eval: the plain composition
    (torch.float32, True, True, 12),     # f32 too: x rounded to bf16
    (torch.bfloat16, True, False, 0),    # fused_mbconv off
])
def test_block_routes(dtype, train, fused, calls, monkeypatch):
    """``fused`` only picks the route: ``mbconv_core`` for the stride-1
    blocks of a train-mode forward in either dtype, as the JAX fused block,
    the plain composition otherwise."""
    seen = []

    def counting_core(*args):
        seen.append(args[0].shape)
        return real(*args)

    real = efficientnet.mbconv_core
    monkeypatch.setattr(efficientnet, "mbconv_core", counting_core)
    net = EfficientNet(in_chans=1, fused=fused).to(dtype).train(train)
    with torch.no_grad():
        out = net(torch.randn(2, 32, 32, 1))
    assert out.shape == (2, 1280) and out.dtype == dtype
    assert len(seen) == calls
    if calls:  # NHWC views of the block inputs
        assert seen[0] == (2, 16, 16, 32) and seen[-1] == (2, 1, 1, 192)


def test_se_widths_follow_the_block_input():
    """max(1, int(0.25 · block input)): B0's stride-1 blocks take SE
    widths 8, 6, 10, 20, 20, 20, 28, 28, 48, 48, 48, 48."""
    net = EfficientNet(in_chans=1)
    widths = [getattr(net, n).se.reduce.out_channels for n in net.block_names
              if getattr(net, n).stride == 1]
    assert widths == [8, 6, 10, 20, 20, 20, 28, 28, 48, 48, 48, 48]
    assert len(EfficientNet(in_chans=1, depth_mult=1.1).block_names) == 23


# ------------------------------ ProfileCNN -------------------------------

@pytest.mark.parametrize("norm,train", [("batch", False), ("batch", True),
                                        ("group", True)])
def test_profile_cnn_f32_matches_flax(norm, train):
    """Stem, −inf-padded max pool, four stages, global max and the
    metadata scalar (profile_len / L) in f32, dropout 0."""
    kw = dict(dim_in=6, blocks=(2, 1, 1, 1), base_channels=16,
              dropout=0.0, norm=norm)
    rs = np.random.RandomState(4)
    # all-negative inputs: a pool padded with 0 would win the max
    profile = (rs.randn(8, 32, 6) - 3.0).astype(np.float32)
    plen = rs.randint(20, 2000, (8, 1)).astype(np.int32)
    jmodel = JaxProfileCNN(dtype=jnp.float32, **kw)
    variables = _np(jmodel.init(jax.random.key(1), jnp.asarray(profile),
                                jnp.asarray(plen)))
    if norm == "batch" and not train:
        variables = _random_stats(variables, 5)
    want, upd = jmodel.apply(variables, jnp.asarray(profile),
                             jnp.asarray(plen), train=train,
                             mutable=["batch_stats"])
    model = ProfileCNN(**kw)
    model.load_state_dict(from_flax(variables), strict=True)
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(profile), torch.from_numpy(plen))
    assert got.shape == (8, model.dim_out) == (8, 16 * 8 + 1)
    _close(got.numpy(), want, F32_TOL, "features")
    if norm == "batch":
        _stats_close(model, upd["batch_stats"] if train
                     else variables["batch_stats"], F32_TOL)


def test_convert_maps_the_b0_and_cnn_trees_one_to_one(b0_variables):
    """Every Flax leaf lands on one port tensor of the shape the rules
    give (HWIO → OIHW, depthwise (k, k, 1, C) → (C, 1, k, k), Conv1d (K, I,
    O) → (O, I, K), batch_stats → running_*), and loads strictly."""
    cnn_vars = _np(JaxProfileCNN(blocks=(2, 2, 2, 2)).init(
        jax.random.key(2), jnp.zeros((2, 32, 6)),
        jnp.ones((2, 1), jnp.int32)))
    for variables, module in ((b0_variables, EfficientNet(in_chans=1)),
                              (cnn_vars, ProfileCNN())):
        sd = from_flax(variables)
        assert sorted(sd) == sorted(module.state_dict())
        module.load_state_dict(sd, strict=True)
        n_leaves = len(jax.tree.leaves(variables))
        assert len(sd) == n_leaves
    block = b0_variables["params"]["stage6_block1"]
    sd = from_flax(b0_variables)
    np.testing.assert_array_equal(
        sd["stage6_block1.dw_conv.weight"].numpy(),
        block["dw_conv"]["kernel"].transpose(3, 2, 0, 1))
    assert sd["stage6_block1.dw_conv.weight"].shape == (1152, 1, 5, 5)
    assert sd["stage6_block1.se.reduce.weight"].shape == (48, 1152, 1, 1)
    np.testing.assert_array_equal(
        sd["stage6_block1.project_bn.running_var"].numpy(),
        b0_variables["batch_stats"]["stage6_block1"]["project_bn"]["var"])
    cnn_sd = from_flax(cnn_vars)
    np.testing.assert_array_equal(
        cnn_sd["stage2_block0.conv1.weight"].numpy(),
        cnn_vars["params"]["stage2_block0"]["conv1"]["kernel"].transpose(
            2, 1, 0))
    assert cnn_sd["stage2_block0.proj_conv.weight"].shape == (64, 32, 1)
