"""The shared Hopper GEMM's host side on the CPU (``ops/hopper_gemm.py``):
its plain versions against ``jnp.dot`` in f32, its tile and group choices,
TMA's row rule, and the scratch layouts and channel rules of kernels 10
and 13-16 that rest on it. The kernels themselves run only on a card
(``tests/test_torch_cuda.py``, marked ``gpu``).

``gemm_rows_reference`` rounds once to bf16 after an f32 sum, as
``jnp.dot(..., preferred_element_type=f32)`` then a cast does: both sum in
f32 in another order, so an output may land one bf16 step (2^-7 relative
at most) apart. ``wgrad_reference`` is f32 throughout: 1e-5 of the largest
|value|. ``gemm_sums_reference``'s chunk sums are held to f32 sums of the
same rounded rows in numpy, within 1e-5 of the largest |sum|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_torch.ops import (
    ffn, hopper_gemm, mbconv,
)
from torch_threads import one_thread  # noqa: F401  (autouse)


def _bf16(rs, *shape, scale=1.0):
    return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)
                            ).to(torch.bfloat16)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("m,n,k", [(37, 24, 144), (70, 40, 8), (5, 72, 200)])
def test_gemm_rows_reference_matches_jnp(m, n, k, transposed, with_bias):
    rs = np.random.RandomState(m + n + k)
    a = _bf16(rs, m, k)
    w = _bf16(rs, *((k, n) if transposed else (n, k)), scale=k ** -0.5)
    bias = torch.from_numpy(rs.randn(n).astype(np.float32)) \
        if with_bias else None
    got = hopper_gemm.gemm_rows(a, w, bias, transposed)  # CPU: plain
    wj = jnp.asarray(w.float().numpy())
    want = jnp.dot(jnp.asarray(a.float().numpy()),
                   wj if transposed else wj.T,
                   preferred_element_type=jnp.float32)
    if bias is not None:
        want = want + jnp.asarray(bias.numpy())
    want = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    err = np.abs(got.float().numpy() - want)
    assert (err <= 2.0 ** -7 * np.abs(want) + 1e-6).all(), err.max()


@pytest.mark.parametrize("rows,n,k", [(100, 24, 144), (7, 8, 8),
                                      (300, 40, 72)])
def test_wgrad_reference_matches_jnp(rows, n, k):
    rs = np.random.RandomState(rows)
    g, x = _bf16(rs, rows, n), _bf16(rs, rows, k)
    dw, db = hopper_gemm.wgrad(g, x)  # CPU: plain
    gj, xj = jnp.asarray(g.float().numpy()), jnp.asarray(x.float().numpy())
    want_dw = np.asarray(jnp.dot(gj.T, xj,
                                 preferred_element_type=jnp.float32))
    want_db = np.asarray(gj.sum(0))
    assert dw.shape == (n, k) and db.shape == (n,)
    for got, want in ((dw, want_dw), (db, want_db)):
        assert np.abs(got.numpy() - want).max() <= \
            1e-5 * np.abs(want).max()


@pytest.mark.parametrize("k,boxes", [(8, 1), (64, 1), (72, 2), (128, 2),
                                     (144, 3), (192, 3), (240, 2), (384, 3),
                                     (480, 2), (672, 2), (1152, 3)])
def test_wgrad_tile_boxes(k, boxes):
    """A weight-gradient block owns 3 column boxes where they divide K's,
    else 2, and 1 where K fits one box (``wgrad_tj`` in the header)."""
    assert hopper_gemm.wgrad_tile_boxes(k) == boxes


@pytest.mark.parametrize("rows,n,k", [(50432, 576, 192), (50432, 192, 192),
                                      (12608, 1152, 384), (14400, 384, 128),
                                      (100, 576, 192), (1, 192, 192)])
def test_wgrad_groups_keep_the_attention_blocks_choice(rows, n, k):
    """At the attention block's widths (multiples of 64) the shared rule
    gives the groups of that block's own tiling: two blocks an SM over
    (N / 64) x (K / TK) tiles, TK 192 where it divides K, else 128, at
    most one group a 64-row chunk."""
    tiles = (n // 64) * (k // (192 if k % 192 == 0 else 128))
    want = max(1, min(-(-rows // 64), -(-2 * 132 // tiles)))
    assert hopper_gemm.wgrad_groups(rows, n, k, 132) == want


@pytest.mark.parametrize("rows,n,k", [(3136 * 64, 24, 144),
                                      (49 * 64, 192, 1152), (5, 24, 144)])
def test_wgrad_groups_at_b0s_widths(rows, n, k):
    """Ragged widths: the tiles round up to whole boxes; the groups fill
    two blocks an SM and never exceed the 64-row chunks."""
    g = hopper_gemm.wgrad_groups(rows, n, k, 132)
    tiles = -(-n // 64) * -(-(-(-k // 64)) // hopper_gemm.wgrad_tile_boxes(k))
    assert 1 <= g <= -(-rows // 64)
    assert g == min(-(-rows // 64), -(-264 // tiles))


def test_check_rows_takes_16_byte_rows_only():
    hopper_gemm.check_rows(torch.zeros((4, 24), dtype=torch.bfloat16), "a")
    with pytest.raises(ValueError, match="16 bytes"):
        hopper_gemm.check_rows(torch.zeros((4, 20), dtype=torch.bfloat16),
                               "a")
    with pytest.raises(ValueError, match="bf16"):
        hopper_gemm.check_rows(torch.zeros((4, 24)), "a")
    with pytest.raises(ValueError, match="bf16"):
        hopper_gemm.check_rows(
            torch.zeros((24, 4), dtype=torch.bfloat16).t(), "a")
    with pytest.raises(ValueError, match="aligned"):
        hopper_gemm.check_rows(
            torch.zeros(4 * 24 + 1, dtype=torch.bfloat16)[1:].view(4, 24),
            "a")


@pytest.mark.parametrize("rows,e,fp,groups", [(50432, 192, 768, 22),
                                              (57600, 192, 2048, 9),
                                              (12608, 384, 1536, 6),
                                              (1, 64, 64, 1)])
def test_ffn_bwd_scratch_layout(rows, e, fp, groups):
    """Kernel 10's scratch: bf16 dpre and h (rows, Fp), the per-tile f32
    column sums (ceil(rows / 64), Fp + E), the group partials (groups,
    Fp E) f32; back to back on 256-byte boundaries, 4 rows Fp bytes for
    the two stored activations."""
    layout, total = ffn.bwd_scratch(rows, e, fp, groups)
    tiles = -(-rows // 64)
    want = {"dpre": rows * fp * 2, "h": rows * fp * 2,
            "colpart": tiles * (fp + e) * 4, "wpart": groups * fp * e * 4}
    assert {k: n for k, (_, n) in layout.items()} == want
    offsets = [o for o, _ in layout.values()]
    assert offsets[0] == 0 and all(o % 256 == 0 for o in offsets)
    ends = [o + n for o, n in layout.values()]
    assert all(e <= o for e, o in zip(ends, offsets[1:]))
    assert ends[-1] <= total < ends[-1] + 256
    assert layout["dpre"][1] + layout["h"][1] == 4 * rows * fp


@pytest.mark.parametrize("cin,mid", [(24, 144), (32, 32), (192, 1152),
                                     (8, 48)])
def test_mbconv_channels_kernel_16_takes(cin, mid):
    """Channel counts on the 16-byte line run as they are: the padding
    route leaves them and their operands alone."""
    assert [mbconv.kernel_channels(c) for c in (cin, mid)] == [cin, mid]
    x, wexp = torch.ones((1, 2, 2, cin)), torch.ones((cin, mid))
    padded = mbconv.pad_mbconv(x, wexp, *_mbconv_weights(cin, mid, 8, 3))
    assert padded[0] is x and padded[1] is wexp


@pytest.mark.parametrize("cin,mid", [(12, 72), (24, 140), (3, 3)])
def test_mbconv_channels_kernel_16_refuses(cin, mid):
    """Channel counts off the 16-byte line, which kernels 13-16 refused
    before: now taken, each rounded up to the next multiple of 8 with zero
    channels (x's, wexp's rows and columns, mid's vectors)."""
    ci, mi = (-(-c // 8) * 8 for c in (cin, mid))
    assert [mbconv.kernel_channels(c) for c in (cin, mid)] == [ci, mi]
    x, wexp = torch.ones((1, 2, 2, cin)), torch.ones((cin, mid))
    px, pwexp, g1, *_ = mbconv.pad_mbconv(
        x, wexp, *_mbconv_weights(cin, mid, 8, 3))
    assert px.shape == (1, 2, 2, ci) and pwexp.shape == (ci, mi)
    assert float(px[..., cin:].abs().sum() + pwexp[cin:].abs().sum()
                 + pwexp[:, mid:].abs().sum() + g1[mid:].abs().sum()) == 0.0
    assert torch.equal(px[..., :cin], x) and torch.equal(
        pwexp[:cin, :mid], wexp)


@pytest.mark.parametrize("cout", [16, 24, 40, 80, 112, 192, 320])
def test_mbconv_channels_kernel_15_takes_b0_couts(cout):
    """B0's projection widths are rows of a multiple of 16 bytes."""
    assert mbconv.kernel_channels(cout) == cout


@pytest.mark.parametrize("cout", [12, 20, 3, 100])
def test_mbconv_channels_kernel_15_refuses(cout):
    """A cout off the 16-byte line: wproj's columns padded with zeros to
    the next multiple of 8 (and y3, m3, v3, dwproj cut back)."""
    co = -(-cout // 8) * 8
    assert mbconv.kernel_channels(cout) == co
    weights = _mbconv_weights(144, 144, cout, 3)
    wproj = mbconv.pad_mbconv(None, None, *weights)[-1]
    assert wproj.shape == (144, co) and float(wproj[:, cout:].abs().sum()) \
        == 0.0 and torch.equal(wproj[:, :cout], weights[-2])


def _mbconv_weights(cin, mid, cout, k, r=4):
    """(g1, b1, wdw, g2, b2, wr, br, we, be, wproj, k) of ones, for
    ``pad_mbconv`` after x and wexp."""
    return (torch.ones(mid), torch.ones(mid), torch.ones((k, k, mid)),
            torch.ones(mid), torch.ones(mid), torch.ones((mid, r)),
            torch.ones(r), torch.ones((r, mid)), torch.ones(mid),
            torch.ones((mid, cout)), k)


@pytest.mark.parametrize("b,h,w,mid,r,cout,groups", [
    (64, 56, 56, 144, 6, 24, 22), (64, 112, 112, 32, 8, 16, 132),
    (64, 7, 7, 1152, 48, 320, 3), (3, 9, 9, 144, 6, 24, 1),
    (1, 1, 1, 8, 1, 8, 1)])
def test_kb_bwd_scratch_layout(b, h, w, mid, r, cout, groups):
    """Kernel 15's scratch: the per-tile column sums (2, B·ceil(HW / 64),
    mid) f32, a tile never holding two samples; the per-sample sums (2,
    B, mid), SE values (4, B, mid) and (2, B, r) f32; a3 (B·H·W, mid) bf16;
    the dwproj group partials (groups, mid·cout) f32; back to back on
    256-byte boundaries."""
    layout, total = mbconv.kb_bwd_scratch(b, h, w, mid, r, cout, groups)
    tiles = b * -(-(h * w) // 64)
    want = {"part": 2 * tiles * mid * 4,
            "sample": (2 * b * mid + 4 * b * mid + 2 * b * r) * 4,
            "a3": b * h * w * mid * 2, "wpart": groups * mid * cout * 4}
    assert {k: n for k, (_, n) in layout.items()} == want
    offsets = [o for o, _ in layout.values()]
    assert offsets[0] == 0 and all(o % 256 == 0 for o in offsets)
    ends = [o + n for o, n in layout.values()]
    assert all(e <= o for e, o in zip(ends, offsets[1:]))
    assert ends[-1] <= total < ends[-1] + 256


@pytest.mark.parametrize("m,n,k", [(200, 24, 24), (130, 144, 24),
                                   (77, 1152, 192), (64, 8, 8)])
def test_gemm_sums_reference_matches_jnp(m, n, k):
    """The column-sum GEMM's plain version: c as ``jnp.dot`` rounds it, and
    per 64-row chunk (2·ceil(M / 128) of them, 0 past M) the column sums
    of the rounded c and of its squares."""
    rs = np.random.RandomState(m + n)
    a, w = _bf16(rs, m, k), _bf16(rs, k, n, scale=k ** -0.5)
    c, sums = hopper_gemm.gemm_sums(a, w)  # CPU: plain
    want = jnp.dot(jnp.asarray(a.float().numpy()),
                   jnp.asarray(w.float().numpy()),
                   preferred_element_type=jnp.float32)
    want = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
    assert c.dtype == torch.bfloat16 and c.shape == (m, n)
    err = np.abs(c.float().numpy() - want)
    assert (err <= 2.0 ** -7 * np.abs(want) + 1e-6).all(), err.max()
    chunks = 2 * -(-m // 128)
    assert sums.shape == (2, chunks, n) and sums.dtype == torch.float32
    rows = np.zeros((chunks * 64, n), np.float32)
    rows[:m] = c.float().numpy()
    rows = rows.reshape(chunks, 64, n)
    for got, ref in ((sums[0], rows.sum(1)), (sums[1], (rows ** 2).sum(1))):
        assert np.abs(got.numpy() - ref).max() <= \
            1e-5 * max(1.0, np.abs(ref).max())
    assert (sums[:, -(-m // 64):] == 0).all()  # chunks wholly past M


@pytest.mark.parametrize("w,tiles", [(112, 4), (56, 2), (28, 1), (14, 1),
                                     (7, 1), (9, 1), (33, 2), (64, 2),
                                     (65, 3)])
def test_dw_tiles(w, tiles):
    """The depthwise passes' tiles: 8 rows by W in the fewest column tiles
    of at most 32 (``dw_tile`` in ``csrc/mbconv.cuh``), per sample."""
    cols = -(-w // tiles)
    assert cols <= 32 and -(-w // cols) == tiles
    assert mbconv.dw_tiles(3, 17, w) == 3 * 3 * tiles


@pytest.mark.parametrize("b,h,w,mid,expand", [
    (64, 112, 112, 32, False), (64, 56, 56, 144, True),
    (64, 7, 7, 1152, True), (3, 9, 9, 144, True), (1, 1, 1, 8, True)])
def test_ka_fwd_scratch_layout(b, h, w, mid, expand):
    """Kernel 13's scratch: y1 (B·H·W, mid) bf16 with an expand; the GEMM's
    chunk sums (2, 2·ceil(B·H·W / 128), mid) f32; the depthwise tiles' sums
    (2, tiles, mid) f32; the first reduction level (2, ceil(rows / 256),
    mid) f32 for the taller of the two; back to back on 256-byte
    boundaries."""
    layout, total = mbconv.ka_fwd_scratch(b, h, w, mid, expand)
    n = b * h * w
    chunks = 2 * -(-n // 128) if expand else 0
    tiles = mbconv.dw_tiles(b, h, w)
    want = {"y1": n * mid * 2 if expand else 0,
            "part1": 2 * chunks * mid * 4, "part2": 2 * tiles * mid * 4,
            "level": 2 * -(-max(chunks, tiles) // 256) * mid * 4}
    assert {k: v for k, (_, v) in layout.items()} == want
    offsets = [o for o, _ in layout.values()]
    assert offsets[0] == 0 and all(o % 256 == 0 for o in offsets)
    ends = [o + v for o, v in layout.values()]
    assert all(e <= o for e, o in zip(ends, offsets[1:]))
    assert ends[-1] <= total < ends[-1] + 256


@pytest.mark.parametrize("b,h,w,mid,cout", [
    (64, 112, 112, 32, 16), (64, 56, 56, 144, 24), (64, 7, 7, 1152, 320),
    (3, 9, 9, 144, 24), (1, 1, 1, 8, 8)])
def test_kb_fwd_scratch_layout(b, h, w, mid, cout):
    """Kernel 14's scratch: a2 (B·H·W, mid) bf16; then f32: the squeeze's
    per-tile sums (T, mid) for T = B·ceil(HW / 64) tiles of one sample
    each; per-sample sums, se (B, mid) each; the projection's per-tile
    sums (2, T, cout); their first reduction level (2, ceil(T / 256),
    cout); on 256-byte boundaries, so that TMA and 16-byte loads take
    every part."""
    layout, total = mbconv.kb_fwd_scratch(b, h, w, mid, cout)
    tiles = b * -(-(h * w) // 64)
    want = {"a2": b * h * w * mid * 2, "sq": tiles * mid * 4,
            "sample": b * mid * 4, "se": b * mid * 4,
            "part": 2 * tiles * cout * 4,
            "level": 2 * -(-tiles // 256) * cout * 4}
    assert {k: v for k, (_, v) in layout.items()} == want
    offsets = [o for o, _ in layout.values()]
    assert offsets[0] == 0 and all(o % 256 == 0 for o in offsets)
    ends = [o + v for o, v in layout.values()]
    assert all(e <= o for e, o in zip(ends, offsets[1:]))
    assert ends[-1] <= total < ends[-1] + 256


def test_mbconv_channel_rule_names_kernels_13_to_16():
    """The widths kernels 13-16 run at mid 140: 144, every mid operand
    padded (wdw's, g and b's, be's and we's columns, wr's rows, wproj's
    rows), the gradients cut back to 140 by ``unpad_mbconv_grads``."""
    padded = mbconv.pad_mbconv(torch.ones((1, 2, 2, 24)),
                               torch.ones((24, 140)),
                               *_mbconv_weights(24, 140, 24, 3))
    x, wexp, g1, b1, wdw, g2, b2, wr, br, we, be, wproj = padded
    assert wexp.shape == (24, 144) and wdw.shape == (3, 3, 144)
    assert all(t.shape == (144,) for t in (g1, b1, g2, b2, be))
    assert wr.shape == (144, 4) and we.shape == (4, 144)
    assert wproj.shape == (144, 24) and br.shape == (4,)
    grads = mbconv.unpad_mbconv_grads(
        (x, *(torch.ones_like(t) for t in padded[1:])), 24, 140, 24)
    assert [tuple(g.shape) for g in grads] == [
        (1, 2, 2, 24), (24, 140), (140,), (140,), (3, 3, 140), (140,),
        (140,), (140, 4), (4,), (4, 140), (140,), (140, 24)]
    assert all(g.is_contiguous() for g in grads)


def _padded_launch(monkeypatch, kernel, seen):
    """Route CPU tensors to the kernels' side of the wrappers; the aligned
    kernel call ``kernel`` (``_ka_fwd``, ``_kb_fwd``) records the channel
    counts it is handed and runs its plain version on them."""
    plain = {"_ka_fwd": mbconv.ka_fwd_reference,
             "_kb_fwd": mbconv.kb_fwd_reference}[kernel]

    def fake(*args):
        seen.append([a.shape[-1] for a in args
                     if isinstance(a, torch.Tensor) and a.dim() == 4])
        assert all(c % 8 == 0 for c in seen[-1])
        return plain(*args)

    monkeypatch.setattr(mbconv, "_on_cpu", lambda t: False)
    monkeypatch.setattr(mbconv, kernel, fake)


@pytest.mark.parametrize("cin,mid,what", [(12, 72, "cin = 12"),
                                          (24, 140, "mid = 140"),
                                          (20, 20, "cin = 20")])
def test_ka_fwd_checks_channels_before_any_launch(monkeypatch, cin, mid,
                                                  what):
    """Kernel 13's wrapper applies the channel rule (with and without an
    expand) before the launch: the channels it once refused (``what``)
    reach the kernel padded to multiples of 8, and its outputs come back
    cut to the true widths, equal to the plain version's."""
    rs = np.random.RandomState(cin)
    x = _bf16(rs, 1, 5, 5, cin)
    expand = mid != cin
    wexp = torch.from_numpy(rs.randn(cin, mid).astype(np.float32)) \
        if expand else None
    g1 = torch.ones(mid) if expand else None
    b1 = torch.zeros(mid) if expand else None
    wdw = torch.from_numpy(rs.randn(3, 3, mid).astype(np.float32))
    seen = []
    _padded_launch(monkeypatch, "_ka_fwd", seen)
    got = mbconv.ka_fwd(x, wexp, g1, b1, wdw, 3)
    assert seen == [[-(-cin // 8) * 8]], what
    want = mbconv.ka_fwd_reference(x, wexp, g1, b1, wdw, 3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mid,cout,what", [(72, 12, "cout = 12"),
                                           (140, 24, "mid = 140")])
def test_kb_fwd_checks_channels_before_any_launch(monkeypatch, mid, cout,
                                                  what):
    """Kernel 14's wrapper applies the channel rule to mid and cout before
    the launch: y2 reaches the kernel padded to a multiple of 8, y3 and
    its statistics come back cut to cout, equal to the plain version's."""
    rs = np.random.RandomState(mid)
    y2 = _bf16(rs, 1, 5, 5, mid)

    def rnd(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))

    args = (rnd(mid), rnd(mid), rnd(mid), rnd(mid).abs(), rnd(mid, 2),
            rnd(2), rnd(2, mid), rnd(mid), rnd(mid, cout))
    seen = []
    _padded_launch(monkeypatch, "_kb_fwd", seen)
    got = mbconv.kb_fwd(y2, *args)
    assert seen == [[-(-mid // 8) * 8]], what
    for g, w in zip(got, mbconv.kb_fwd_reference(y2, *args)):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
