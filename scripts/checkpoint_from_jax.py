#!/usr/bin/env python3
"""Carry an orbax checkpoint directory of the JAX package over to the
PyTorch port's checkpoint format (``train/checkpoint.py`` of the port).

    python scripts/checkpoint_from_jax.py -k logs/run/version_0/checkpoints \\
        -o logs/run/version_0/checkpoints_torch

Runs where JAX is installed (it imports the JAX package, so it lives
outside the port). Any kind the JAX drivers write: the contrastive
``multi`` model, the ``image`` and ``profile`` classifiers (rebuilt over
the stored class names). For every kept step it restores the orbax tree as host
numpy (the JAX manager's template-free restore), maps the parameters and
batch statistics with ``convert.from_flax``, the optax SGD momentum trace
onto each master's ``momentum_buffer`` (in ``TrainState.params`` order;
a zero trace acts as a fresh buffer, since mu·0 + g = g) and, for a card
with ``accumulate_grad_batches`` > 1, ``MultiSteps``' ``acc_grads`` onto
``grad_acc`` (the port takes the position in the accumulation from
``step``, so ``mini_step`` must equal ``step % k``). The metadata is
copied with ``format: "torch"`` added; each step keeps its metric.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Any, Mapping, Optional

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def _find(tree: Any, key: str) -> Optional[Any]:
    """The value under the first mapping in ``tree`` (nested mappings and
    sequences, as orbax restores optax states) that holds ``key``."""
    if isinstance(tree, Mapping):
        if key in tree:
            return tree[key]
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for item in tree:
            found = _find(item, key)
            if found is not None:
                return found
    return None


def _in_order(names, tree) -> dict:
    """``tree`` (a Flax-shaped tree like the params) as port tensors in
    the order of ``names``."""
    from multimodal_plankton_recognition_torch.convert import from_flax

    converted = from_flax({"params": tree})
    return {n: converted[n] for n in names}


def bridge(jax_dir: Path | str, out_dir: Path | str) -> list[int]:
    """Write every step of the orbax directory ``jax_dir`` to ``out_dir``
    in the port's format; returns the steps written."""
    import orbax.checkpoint as ocp

    from multimodal_plankton_recognition_tpu.train.checkpoint import (
        CheckpointManager as JaxCheckpointManager, read_metadata,
    )
    from multimodal_plankton_recognition_torch.config import ModelCard
    from multimodal_plankton_recognition_torch.convert import from_flax
    from multimodal_plankton_recognition_torch.models.build import (
        build_for_kind,
    )
    from multimodal_plankton_recognition_torch.train import (
        create_train_state, make_optimizer,
    )
    from multimodal_plankton_recognition_torch.train.checkpoint import (
        FORMAT, CheckpointManager,
    )

    jax_dir = Path(jax_dir).resolve()
    meta = read_metadata(jax_dir)
    if meta.get("format") == FORMAT:
        raise ValueError(f"{jax_dir} is already in the port's format")
    card = ModelCard.from_dict(meta["card"])
    kind = meta.get("kind", "multi")
    every_k = card.trainer_args.accumulate_grad_batches
    monitor = meta.get("_monitor", "valid_loss")
    reader = ocp.CheckpointManager(jax_dir)
    steps = reader.all_steps()
    metrics = {s: reader.metrics(s) or {} for s in steps}
    reader.close()
    jax_mngr = JaxCheckpointManager(jax_dir, monitor=monitor,
                                    mode=meta.get("_mode", "min"),
                                    save_top_k=-1)
    out = CheckpointManager(
        out_dir, monitor=monitor, mode=meta.get("_mode", "min"),
        save_top_k=-1,
        metadata={k: v for k, v in meta.items()
                  if k not in ("_monitor", "_mode")})
    tx = make_optimizer(card.optim_args, every_k)
    for step_dir in steps:
        restored = jax_mngr.restore(step_dir)
        variables = {"params": restored["params"]}
        if restored.get("batch_stats"):
            variables["batch_stats"] = restored["batch_stats"]
        model = build_for_kind(card, kind, meta.get("class_names", ()))
        state = create_train_state(model, from_flax(variables), tx)
        state.step = int(np.asarray(restored["step"]))
        opt_state = restored["opt_state"]
        if every_k > 1:
            mini_step = int(np.asarray(_find(opt_state, "mini_step")))
            if mini_step != state.step % every_k:
                raise ValueError(
                    f"step {step_dir}: MultiSteps mini_step {mini_step} is "
                    f"not step % k = {state.step} % {every_k}")
            if mini_step:
                state.grad_acc = _in_order(
                    state.params, _find(opt_state, "acc_grads"))
        trace = _find(opt_state, "trace")
        if trace is not None:
            for name, buf in _in_order(state.params, trace).items():
                state.opt.state[state.params[name]]["momentum_buffer"] = buf
        value = metrics[step_dir].get(monitor)
        if not out.save(step_dir, state, {monitor: value}):
            raise ValueError(f"step {step_dir}: no finite {monitor!r} "
                             f"metric to carry over ({metrics[step_dir]})")
    jax_mngr.close()
    return steps


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-k", "--checkpoint", required=True,
                        help="orbax checkpoint directory of the JAX package "
                             "(with plankton_metadata.json)")
    parser.add_argument("-o", "--output", required=True,
                        help="new directory for the port's checkpoints")
    args = parser.parse_args()
    steps = bridge(args.checkpoint, args.output)
    print(f"Carried steps {steps} from {args.checkpoint} to {args.output}")


if __name__ == "__main__":
    main()
