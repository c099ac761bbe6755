"""What train-mode dropout has to produce, judged from one call of each
kind that the timed train step made: its inputs and its output.

* Dropout of attention probabilities: o = (P ⊙ m / (1 − p)) v with
  P = softmax(q kᵀ / √d + key bias) and m a Bernoulli(1 − p) keep bit a
  probability. Its expectation is P v, and each element's variance
  p / (1 − p) Σ_k P²_ik v²_kj, and the output's rounding to its dtype
  adds ulp² / 12. r, a row's (sample, head, query) mean of
  z² = (o − P v)² / variance, is 1 in expectation; rows draw independent
  bits. ``attn_drop_var_z``: |mean r − 1| in standard errors of that
  mean. ``attn_drop_bias_z``: the slope of o − P v on P v, in its
  standard errors (0 with the 1 / (1 − p) factor, −p without it).
* Elementwise dropout: y = x ⊙ m / (1 − p). ``drop_share_z``: the share
  of nonzero inputs dropped against p, in binomial standard errors.
  ``drop_scale_gap``: the largest |y (1 − p) / x − 1| over the kept ones.

Of the attention core, the step's first call of each shape is judged
(one an encoder: the ViT's blocks and the profile transformer's). P is
worked out in float32 from the q|k|v that the program handed its
attention core in that step: its own state, which the step's check at
rate 0 (``harness/compare.py``) has compared up to there. Imports
nothing of the measured program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

ATTENTION_NUMBERS = ("attn_drop_var_z", "attn_drop_bias_z")
ELEMENTWISE_NUMBERS = ("drop_share_z", "drop_scale_gap")


def _z(x: float, se: float) -> float:
    return abs(x) / se if se > 0 else (0.0 if x == 0 else math.inf)


def rounding_variance(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The variance that rounding ``x`` to ``dtype`` adds: ulp² / 12, the
    ulp of a value in [2^e, 2^(e+1)) being eps · 2^e."""
    _, exponent = torch.frexp(x)
    ulp = torch.finfo(dtype).eps * torch.exp2(exponent.float() - 1)
    return ulp * ulp / 12


def attention_numbers(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                      heads: int, p: float, out: torch.Tensor,
                      block: int = 16) -> Dict[str, float]:
    """``qkv`` (B, L, 3E) packed q|k|v, ``bias`` (B, L) the keys' additive
    bias or None, ``out`` (B, L, E) the program's output at rate ``p``."""
    b, l, e3 = qkv.shape
    d = e3 // (3 * heads)
    rows, slope_num, slope_den = [], [], []
    for i in range(0, b, block):
        x = qkv[i:i + block].float().reshape(-1, l, 3, heads, d)
        q, k, v = (x[:, :, j].transpose(1, 2) for j in range(3))
        s = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        if bias is not None:
            s = s + bias[i:i + block].float()[:, None, None, :]
        prob = torch.softmax(s, dim=-1)
        mean = prob @ v
        var = (prob * prob) @ (v * v) * (p / (1.0 - p)) \
            + rounding_variance(mean, out.dtype)
        o = out[i:i + block].float().reshape(-1, l, heads, d) \
            .transpose(1, 2)
        diff = o - mean
        held = var > 1e-6 * var.mean()
        z2 = torch.where(held, diff * diff / var.clamp_min(1e-30), 0.0)
        rows.append((z2.sum(-1) / held.sum(-1).clamp_min(1)).flatten())
        slope_num.append((diff * mean).sum(-1).flatten().double())
        slope_den.append((mean * mean).sum(-1).flatten().double())
    r = torch.cat(rows).double()
    if not torch.isfinite(r).all():
        return dict.fromkeys(ATTENTION_NUMBERS, math.inf)
    var_z = _z(float(r.mean()) - 1.0, float(r.std()) / math.sqrt(r.numel()))
    a, c = torch.cat(slope_num), torch.cat(slope_den)
    slope = float(a.sum() / c.sum())
    se = float(((a - slope * c) ** 2).sum().sqrt() / c.sum())
    return {"attn_drop_var_z": var_z, "attn_drop_bias_z": _z(slope, se)}


def elementwise_numbers(x: torch.Tensor, y: torch.Tensor,
                        p: float) -> Dict[str, float]:
    """``x`` the input, ``y`` the program's output at rate ``p``."""
    x, y = x.float(), y.float()
    nonzero = x != 0
    n = int(nonzero.sum())
    if n == 0 or not torch.isfinite(y).all():
        return dict.fromkeys(ELEMENTWISE_NUMBERS, math.inf)
    share = int(((y == 0) & nonzero).sum()) / n
    kept = (y != 0) & nonzero
    scale = (y[kept] * (1.0 - p) / x[kept] - 1.0).abs()
    return {"drop_share_z": _z(share - p, math.sqrt(p * (1 - p) / n)),
            "drop_scale_gap": float(scale.max()) if scale.numel()
            else math.inf}


def dropout_numbers(taps: Dict, device) -> Dict[str, float]:
    """The numbers of the calls in ``taps`` (``harness/taps.py``), worked
    out on ``device``; of several attention calls, the worst."""
    out: Dict[str, float] = {}
    for qkv, bias, heads, p, o in taps.get("attention", ()):
        numbers = attention_numbers(
            qkv.to(device), None if bias is None else bias.to(device),
            heads, p, o.to(device))
        for name, value in numbers.items():
            out[name] = max(out.get(name, 0.0), value)
    if "elementwise" in taps:
        x, y, p = taps["elementwise"]
        out.update(elementwise_numbers(x.to(device), y.to(device), p))
    return out
