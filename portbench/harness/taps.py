"""Taps on the program's dropout sites for one train step, and the
dropout faults that are planted in the program for the readings of
``correct``'s limits.

The program's train step reaches its attention core (``ops/attention.py``
``mha_qkv``, kernels 1-2) and its elementwise dropout
(``models/dropout.py`` ``dropout``) through the names its model modules
import. ``tap_dropout`` points those names, for the duration of a block,
at wrappers that keep the first call of each kind at a rate above 0 (its
inputs and output, copied to the host) and change nothing it returns.
``plant_fault`` points them, until undone, at a faulty version: the
taps then wrap the fault.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Callable, Dict, Iterator

PACKAGE = "multimodal_plankton_recognition_torch"

#: the function each kind of site is reached through now
_bound: Dict[str, Callable] = {}


def _originals() -> Dict[str, Callable]:
    from multimodal_plankton_recognition_torch.models import dropout
    from multimodal_plankton_recognition_torch.ops import attention

    return {"attention": attention.mha_qkv, "elementwise": dropout.dropout}


def _rebind(old: Callable, new: Callable) -> Callable[[], None]:
    """Point every name of the program's loaded modules that holds
    ``old`` at ``new``, except in the module that defines it (its own
    counters stay put); returns the undo."""
    done = []
    for name, mod in list(sys.modules.items()):
        if mod is None or name.split(".")[0] != PACKAGE \
                or name == old.__module__:
            continue
        for attr, value in list(vars(mod).items()):
            if value is old:
                setattr(mod, attr, new)
                done.append((mod, attr))

    def undo() -> None:
        for mod, attr in done:
            setattr(mod, attr, old)
    return undo


def _current(kind: str) -> Callable:
    return _bound.get(kind) or _originals()[kind]


def _host(t):
    return None if t is None else t.detach().to("cpu", copy=True)


@contextlib.contextmanager
def tap_dropout(record: Dict) -> Iterator[Dict]:
    """Inside the block, ``record["attention"]``: a list of (qkv, key
    bias, heads, p, output), the first attention-core call at p > 0 of
    each shape (one an encoder), and ``record["elementwise"]`` = (x, y,
    p) of the first elementwise dropout at p > 0, where the step makes
    them."""
    shapes = set()
    attn, drop = _current("attention"), _current("elementwise")

    def attn_tap(qkv, bias_rows, heads, dropout_p=0.0, seed=0):
        out = attn(qkv, bias_rows, heads, dropout_p, seed)
        shape = (tuple(qkv.shape[1:]), heads, bias_rows is None)
        if dropout_p > 0 and shape not in shapes:
            shapes.add(shape)
            record.setdefault("attention", []).append(
                (_host(qkv), _host(bias_rows), heads, dropout_p, _host(out)))
        return out

    def drop_tap(x, rate, training):
        y = drop(x, rate, training)
        if training and rate > 0 and "elementwise" not in record:
            record["elementwise"] = (_host(x), _host(y), rate)
        return y

    undo = [_rebind(attn, attn_tap), _rebind(drop, drop_tap)]
    try:
        yield record
    finally:
        for u in reversed(undo):
            u()


FAULTS = ("none", "unscaled", "double")


def plant_fault(kind: str) -> Callable[[], None]:
    """A dropout fault in the program at every site: ``none`` drops
    nothing, ``unscaled`` keeps values without the 1 / (1 − p) factor,
    ``double`` drops at twice the rate. Returns the undo."""
    attn, drop = _current("attention"), _current("elementwise")
    if kind == "none":
        def fa(qkv, bias_rows, heads, dropout_p=0.0, seed=0):
            return attn(qkv, bias_rows, heads, 0.0, seed)

        def fd(x, rate, training):
            return drop(x, 0.0, training)
    elif kind == "unscaled":
        def fa(qkv, bias_rows, heads, dropout_p=0.0, seed=0):
            return attn(qkv, bias_rows, heads, dropout_p, seed) \
                * (1.0 - dropout_p)

        def fd(x, rate, training):
            return drop(x, rate, training) * (1.0 - rate) if training \
                else x
    elif kind == "double":
        def fa(qkv, bias_rows, heads, dropout_p=0.0, seed=0):
            return attn(qkv, bias_rows, heads, 2 * dropout_p, seed)

        def fd(x, rate, training):
            return drop(x, 2 * rate, training)
    else:
        raise ValueError(f"no dropout fault {kind!r} (faults: {FAULTS})")
    undo = [_rebind(attn, fa), _rebind(drop, fd)]
    _bound.update(attention=fa, elementwise=fd)

    def undo_all() -> None:
        for u in reversed(undo):
            u()
        _bound.update(attention=attn, elementwise=drop)
    return undo_all
