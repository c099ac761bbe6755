"""One count file an encoder, found by name: an image encoder's by its
``name`` (``vit_tiny_patch16_224.py``), a profile encoder's by
``profile_<kind>.py``. Each gives, from the encoder's arguments and the
card's ``target_size``:

* ``flops(args, size)``: one sample's forward operations;
* ``width(args)``: the features it hands to the projection, before the
  metadata scalars;
* ``attention(args, size, batch, keys)``: its attention-core calls
  (``counts/attention.py``'s ``Call``), none where it has no attention.

An encoder without a file has no count: ``NotImplementedError``. A later
configuration adds its encoder's file and edits none of these.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent


def count_file(args: Dict, role: str):
    """The count module of the ``role`` ("image" or "profile") encoder
    given by ``args``."""
    name = args["name"] if role == "image" else f"profile_{args['kind']}"
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise NotImplementedError(
            f"no count for the {role} encoder {name!r}: add "
            f"portbench/counts/encoders/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_count_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
