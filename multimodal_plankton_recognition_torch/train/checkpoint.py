"""Checkpointing with top-k retention and a one-call restore
(``train/checkpoint.py`` of the JAX package, on a torch format).

The JAX package keeps Lightning ``ModelCheckpoint``'s behaviour (keep
``save_top_k`` checkpoints by the monitored metric) through orbax; this
module keeps the same steps over the same metrics, with orbax's rules:
a step no later than the latest kept one is not saved, and among equal
metrics the later step ranks better. Layout:

    <dir>/plankton_metadata.json   card, kind, class_names, _monitor,
                                   _mode, format: "torch"
    <dir>/<epoch>/state.pt         torch.save payload (CPU tensors)
    <dir>/<epoch>/metrics.json     {monitor: value}

A step directory is written under a hidden temporary name and renamed
into place, so a reader sees a whole checkpoint or none. The payload
holds ``step``, the f32 masters (``params``), the BatchNorm buffers
(``batch_stats``), the optimizer's ``state_dict`` (``opt``) and, while
gradients accumulate, their running mean (``grad_acc``: optax
``MultiSteps``' ``acc_grads``; the position in the accumulation is
``step % every_k``). It loads with ``torch.load(..., weights_only=True)``.

An orbax directory of the JAX package has no ``format`` marker: the
loader refuses it and names ``scripts/checkpoint_from_jax.py``, which
carries it over.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..config import ModelCard
from ..models.build import build_for_kind
from ..ops.knn import require_device

METADATA_FILE = "plankton_metadata.json"
PAYLOAD_FILE = "state.pt"
METRICS_FILE = "metrics.json"
FORMAT = "torch"
BRIDGE = "scripts/checkpoint_from_jax.py"


def _to_cpu(tree):
    """``tree`` (nested dicts and lists of tensors and plain values) with
    every tensor copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _payload(state) -> Dict[str, Any]:
    """The checkpoint payload of a ``TrainState``, on the CPU."""
    return _to_cpu({
        "step": int(state.step),
        "params": state.params,
        "batch_stats": state.batch_stats or {},
        "opt": state.opt.state_dict(),
        "grad_acc": state.grad_acc,
    })


class CheckpointManager:
    """Top-k checkpoints of a run under ``directory`` (Lightning
    ``ModelCheckpoint`` semantics, as the JAX package keeps them):
    ``save_top_k`` 0 saves nothing, -1 keeps every checkpoint, k > 0 keeps
    the best k by ``monitor`` in ``mode`` ('min' or 'max'). ``metadata``
    (card, kind, class names) is written beside the checkpoints with the
    monitor, the mode and the format marker. Opening a directory reads the
    checkpoints already in it."""

    def __init__(self, directory: Path | str, monitor: str = "valid_loss",
                 mode: str = "min", save_top_k: int = 1,
                 metadata: Optional[Dict[str, Any]] = None) -> None:
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self._disabled = save_top_k == 0
        # k > 0 ranks by the metric (orbax best_fn); -1 keeps all and, like
        # orbax without best_fn, calls the latest step the best
        self._keep = save_top_k if save_top_k > 0 else None
        self._metrics: Dict[int, Optional[float]] = {}
        for entry in self.directory.iterdir():
            if entry.name.isdigit() and (entry / PAYLOAD_FILE).is_file():
                self._metrics[int(entry.name)] = self._read_metric(entry)
        if metadata is not None:
            metadata = dict(metadata, _monitor=monitor, _mode=mode,
                            format=FORMAT)
            tmp = self.directory / f".{METADATA_FILE}.tmp-{os.getpid()}"
            tmp.write_text(json.dumps(metadata, indent=2, default=str))
            os.replace(tmp, self.directory / METADATA_FILE)

    def _read_metric(self, step_dir: Path) -> Optional[float]:
        path = step_dir / METRICS_FILE
        if not path.is_file():
            return None
        return json.loads(path.read_text()).get(self.monitor)

    def all_steps(self) -> list[int]:
        return sorted(self._metrics)

    def _ranked(self) -> list[int]:
        """Steps with a metric, worst first; ties keep step order, so the
        later of two equal steps ranks better (orbax's stable sort)."""
        steps = [s for s in self.all_steps() if self._metrics[s] is not None]
        return sorted(steps, key=lambda s: self._metrics[s],
                      reverse=self.mode == "min")

    def save(self, epoch: int, state, metrics: Dict[str, float]) -> bool:
        """Save iff the monitored metric was produced this epoch and is
        finite, and ``epoch`` is later than every kept step; then drop the
        checkpoints outside the top k. True if a checkpoint was written."""
        if self._disabled:
            return False
        value = metrics.get(self.monitor)
        if value is None or not math.isfinite(value):
            return False
        steps = self.all_steps()
        if steps and steps[-1] >= epoch:
            return False
        final = self.directory / str(epoch)
        tmp = self.directory / f".{epoch}.tmp-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        torch.save(_payload(state), tmp / PAYLOAD_FILE)
        (tmp / METRICS_FILE).write_text(
            json.dumps({self.monitor: float(value)}))
        os.rename(tmp, final)
        self._metrics[epoch] = float(value)
        if self._keep is not None and len(self._metrics) > self._keep:
            ranked = self._ranked()
            keep = set(ranked[-self._keep:]) | {
                s for s, m in self._metrics.items() if m is None}
            for step in [s for s in self._metrics if s not in keep]:
                shutil.rmtree(self.directory / str(step))
                del self._metrics[step]
        return True

    def wait(self) -> None:
        """Writes are synchronous: nothing to wait for (``Fitter`` calls
        it)."""

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        if self._keep is None:
            return self.latest_step()
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The payload of ``step`` (default: the best step, else the
        latest), on the CPU."""
        if step is None:
            step = self.best_step()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {self.directory}")
        return torch.load(self.directory / str(step) / PAYLOAD_FILE,
                          map_location="cpu", weights_only=True)


def read_metadata(directory: Path | str) -> Dict[str, Any]:
    with open(Path(directory) / METADATA_FILE) as f:
        return json.load(f)


def read_port_metadata(directory: Path | str) -> Dict[str, Any]:
    """``read_metadata``, refusing a directory without the port's format
    marker (an orbax directory of the JAX package) with a message that
    names the bridge."""
    meta = read_metadata(directory)
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{directory} is not a checkpoint of the PyTorch port: its "
            f"{METADATA_FILE} has no \"format\": \"{FORMAT}\" marker (an "
            f"orbax checkpoint of the JAX package?); carry it over with "
            f"python {BRIDGE} -k {directory} -o <new directory>")
    return meta


def load_from_checkpoint(directory: Path | str, step: Optional[int] = None,
                         device: torch.device | str = "cuda"
                         ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """Rebuild the model from the stored card and kind (``multi``, or an
    ``image`` / ``profile`` classifier over the stored class names), load
    a checkpoint into it and place it on ``device`` (the card unless the
    caller names another; without a card the default raises).

    The masters load at the model's compute dtype (``load_state_dict``
    rounds them as ``TrainState.load_into`` does); the BatchNorm
    statistics stay f32. ``step`` defaults to the best step by the
    recorded monitor, else the latest. Returns ``(model, payload,
    metadata)``, the payload on the CPU."""
    device = require_device(device)
    directory = Path(directory).resolve()
    meta = read_port_metadata(directory)
    model = build_for_kind(ModelCard.from_dict(meta["card"]),
                           meta.get("kind", "multi"),
                           meta.get("class_names", ()))
    monitor = meta.get("_monitor")
    mngr = CheckpointManager(directory, monitor=monitor or "valid_loss",
                             mode=meta.get("_mode", "min"),
                             save_top_k=1 if monitor else -1)
    payload = mngr.restore(step)
    model.load_state_dict({**payload["params"], **payload["batch_stats"]},
                          strict=True)
    return model.to(device), payload, meta
