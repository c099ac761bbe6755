"""The B0 CLIP card's bf16 micro-steps with ``fused_mbconv: true``: the
port's plain ``mbconv_core`` against the JAX train step through the Pallas
kernels in interpret mode, on the shrunk card of
``tests/test_torch_b0_card.py`` (32 px, bs 8, buckets 2, accumulation 2,
dropout 0), whose helpers it uses.
"""

import numpy as np
import torch

from test_torch_b0_card import (
    _stats_close, jax_card_run, port_card_run, small_b0_card, update_errors,
)
from torch_threads import one_thread  # noqa: F401  (autouse)


def _flat_update(init, values, names):
    return torch.cat([(values[n] - init[n]).double().flatten()
                      for n in names])


def test_b0_card_bf16_fused_micro_steps_close_to_jax():
    """``fused_mbconv: true`` in bf16: the port's plain ``mbconv_core``
    against the JAX step through the Pallas kernels (interpret mode). The
    losses to 1e-2 relative and the running statistics to 3e-2 of max(1,
    |·|) (the bf16 block bound), both micro-steps. The update itself is
    rounding-dominated at this size (8 samples, B0's last maps 1×1): the
    port's own cuDNN route (``fused_mbconv: false``) lands about as near
    JAX's fused step as its fused route does. So it is held statistically,
    over the concatenated update of every master that is not a structural
    zero: correlation > 0.5, and a median relative L2 per master at most
    1.25× that of the port's cuDNN route against the same JAX step."""
    d, init, want = jax_card_run("16-mixed", True)
    state, got = port_card_run(d, init)
    params = sorted(state.params)
    stats = sorted(state.batch_stats)
    for (loss, values), (jloss, jvalues) in zip(got, want):
        assert abs(loss - jloss) <= 1e-2 * abs(jloss)
        _stats_close(values, jvalues, stats, 3e-2)
    errs, _ = update_errors(init, values, jvalues, params)
    live = sorted(errs)
    a = _flat_update(init, values, live).numpy()
    b = _flat_update(init, jvalues, live).numpy()
    assert np.isfinite(a).all()
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.5, corr
    _, other = port_card_run(small_b0_card("16-mixed", False), init)
    other_errs, _ = update_errors(init, other[-1][1], jvalues, params)
    median = np.median(list(errs.values()))
    other_median = np.median([other_errs[n] for n in live])
    assert median <= 1.25 * other_median, (median, other_median)
