"""Train and eval steps for contrastive pretraining and the epoch loop
(``make_multi_steps`` and ``Fitter`` of the JAX package's
``train/loop.py``).

One train step: load the f32 masters into the compute module, run
``MultiModel.loss`` in train mode with every dropout drawn from a CPU
generator seeded from (seed, step) (``fold_in(rng, state.step)`` in JAX),
backpropagate, upcast the gradients to f32 and update the masters; with
``every_k`` > 1 the gradients are averaged over k micro-steps first
(``optax.MultiSteps``). BatchNorm's running statistics update in the
train-mode forward, so once per micro-step, also while gradients
accumulate, as the JAX step returns ``batch_stats`` every micro-step; the
eval step normalizes with them and leaves them alone. A batch's ``label``
(class ids, for ArcFace) goes to the coordination head. With an
``augment_fn`` (``ops.augment.multi_train_augment``: the random tail of
the train transforms on the card) the step first runs it on the batch,
drawing from a second CPU generator seeded from (seed, step), so the
dropout draws are the same with or without it. Nothing in the step reads
a device value on the host, so steps queue on the card back to back;
``Fitter`` reads the losses once per epoch and hands each epoch to the
checkpointer (``train.checkpoint.CheckpointManager``).

``make_classifier_steps`` gives the supervised classifiers' steps the
same way: cross-entropy on the logits in the module dtype (as JAX takes
``log_softmax`` of them), the same update, and an eval step that also
returns the argmax ``pred`` and the batch's ``label``, from which
``Fitter`` adds ``valid_acc``. The drivers that wire these to a card and
a dataset are ``train.drivers``.

With a ``mesh`` (``parallel.mesh``: one rank of a process group, each
rank a card and its contiguous rows of the global batch) the steps
compute what the JAX package's jitted steps compute under GSPMD on an
n_data-device mesh, the single-device step over the global batch:

* each rank's loss is over its own rows. Buckets are contiguous rows, so
  where ``buckets`` divides by n_data each rank holds whole buckets and
  runs the loss (and its kernels) on ``buckets / n_data`` of them; where
  it does not, every rank gathers all ranks' embeddings
  (``all_gather_rows``) and computes the loss of the global batch;
* the f32 gradients and the loss are averaged over the ranks as one flat
  buffer in a fixed order (``all_reduce_mean_``), so two runs agree bit
  for bit, before accumulation and the update; the mean of the ranks'
  gradients is the global loss's, since each gather's backward sums the
  other ranks' cotangents into this rank's rows;
* BatchNorm takes the global batch's statistics (``batchnorm.
  synchronised``), and a fused MBConv block takes its plain route there
  (kernels 13-16 take per-rank statistics; printed once);
* dropout and the augmentation draw from the step's generators with the
  data rank in their seed (``Mesh.rank_words``), as JAX's shard_map step
  folds in the axis index: a rank's rows get their own draws (JAX's GSPMD
  step draws one mask over the global batch: the same distribution, other
  bits);
* eval losses are the global batch's: the multi step's the mean over the
  ranks, the classifier's the rows' mean over the ranks' rows, which may
  differ in number (a split trailing batch), its ``pred`` and ``label``
  gathered in row order.

On a process group of one rank the collectives run and change no bit, so
the step is ``make_multi_steps``' bit for bit.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.pipeline import device_put
from ..models.batchnorm import synchronised
from ..models.dropout import dropout_rng
from ..ops.losses import cross_entropy_loss
from ..parallel.mesh import (
    Mesh, all_gather_rows, all_reduce_mean_, gather_uneven,
)
from ..utils.tracing import span
from .optim import Optimizer
from .state import TrainState

AUGMENT_STREAM = 1  # the augmentation generator's third seed word


def _step_generator(seed: int, step: int, *stream: int) -> torch.Generator:
    """The CPU generator of one step, seeded from (seed, step) through
    numpy's ``SeedSequence`` (torch's CPU generator keeps 32 bits of a
    seed, so the pair is hashed, not packed); ``stream`` words give
    another generator of the same step."""
    state = np.random.SeedSequence([seed, step, *stream]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def _rank_words(mesh: Optional[Mesh]) -> tuple:
    return () if mesh is None else mesh.rank_words()


def _train_update(model: nn.Module, tx: Optimizer, state: TrainState,
                  seed: int, loss_fn: Callable[[], torch.Tensor],
                  mesh: Optional[Mesh] = None
                  ) -> Tuple[TrainState, torch.Tensor]:
    """One micro-step of either kind: the masters into ``model`` in train
    mode, ``loss_fn()`` under the step's dropout generator (and, over
    several data ranks, synchronised BatchNorm), its backward, the
    gradients upcast to f32 (with a ``mesh``: averaged over the ranks with
    the loss) and, every ``tx.every_k`` micro-steps (their running mean),
    the masters' update. While a profiler records, the micro-step is the
    span ``train.step`` and its phases ``train.load``, ``train.forward``,
    ``train.backward`` and ``train.update`` (``utils.tracing``)."""
    with span("train.step"):
        with span("train.load"):
            state.load_into(model).train()
            model.zero_grad(set_to_none=True)
        with span("train.forward"), dropout_rng(_step_generator(
                seed, state.step, *_rank_words(mesh))), synchronised(mesh):
            loss = loss_fn()
        with span("train.backward"):
            loss.backward()
        with span("train.update"):
            named = dict(model.named_parameters())
            grads = [torch.zeros_like(m) if named[n].grad is None
                     else named[n].grad.float()
                     for n, m in state.params.items()]
            loss = loss.detach()
            if mesh is not None and mesh.distributed:
                total = loss.float().reshape(1)
                all_reduce_mean_([*grads, total], mesh)
                loss = total[0].to(loss.dtype)
            k = tx.every_k
            if k > 1:
                n_acc = state.step % k
                if state.grad_acc is None:
                    state.grad_acc = dict(zip(state.params,
                                              map(torch.zeros_like, grads)))
                acc = list(state.grad_acc.values())
                # Welford running mean, as optax.MultiSteps accumulates
                torch._foreach_add_(acc, torch._foreach_div(
                    torch._foreach_sub(grads, acc), n_acc + 1))
                grads = acc if n_acc == k - 1 else None
            if grads is not None:
                for master, g in zip(state.params.values(), grads):
                    master.grad = g.to(master.dtype)
                state.opt.step()
                if k > 1:
                    state.grad_acc = None
            state.step += 1
    return state, loss


def _mean_over_ranks(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A scalar's mean over the world's ranks (itself without a group)."""
    if mesh is None or not mesh.distributed:
        return x
    total = x.float().reshape(1)
    all_reduce_mean_([total], mesh)
    return total[0].to(x.dtype)


def mesh_multi_loss(model: nn.Module, buckets: int, mesh: Mesh,
                    batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """This rank's contrastive loss whose mean over the ranks is the loss
    of the global batch in ``buckets`` buckets: its own whole buckets, or,
    where ``buckets`` does not divide by the data ranks, the global
    batch's loss from every rank's gathered embeddings."""
    if buckets % mesh.n_data == 0:
        return model.loss(buckets=buckets // mesh.n_data, **batch)
    batch = dict(batch)
    label = batch.pop("label", None)
    emb = model.encode(**batch)
    if label is not None:
        label = all_gather_rows(label, mesh)
    return model.coordination(all_gather_rows(emb["image_emb"], mesh),
                              all_gather_rows(emb["profile_emb"], mesh),
                              buckets=buckets, label=label)


def note_mbconv_route(model: nn.Module, mesh: Optional[Mesh]) -> None:
    """Print once that a fused MBConv model takes the plain route over
    several data ranks, and why."""
    if mesh is None or mesh.n_data == 1:
        return
    if any(getattr(m, "fused", False) and hasattr(m, "takes_fused_route")
           for m in model.modules()):
        print(f"parallel: fused_mbconv takes the unfused MBConv route on "
              f"{mesh.n_data} data ranks: kernels 13-16 compute BatchNorm "
              f"statistics per rank, which would not be synchronised (JAX's "
              f"multi-chip GSPMD route takes no kernel either)", flush=True)


def multi_steps(model: nn.Module, tx: Optimizer,
                loss_of: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                augment_fn: Optional[Callable] = None,
                mesh: Optional[Mesh] = None) -> Tuple[Callable, Callable]:
    """(train_step, eval_step) of a contrastive model whose loss of a
    batch is ``loss_of(batch)``: the body of ``make_multi_steps`` and of
    the per-rank step (``train.shard_step``)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   seed: int) -> Tuple[TrainState, torch.Tensor]:
        """One micro-step; returns the updated state and the loss (a
        device scalar)."""
        if augment_fn is not None:
            batch = augment_fn(batch, _step_generator(
                seed, state.step, AUGMENT_STREAM, *_rank_words(mesh)))
        return _train_update(model, tx, state, seed,
                             lambda: loss_of(batch), mesh)

    @torch.no_grad()
    def eval_step(state: TrainState,
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        state.load_into(model).eval()
        return {"loss": _mean_over_ranks(loss_of(batch), mesh)}

    return train_step, eval_step


def make_multi_steps(model: nn.Module, tx: Optimizer, buckets: int = 1,
                     augment_fn: Optional[Callable] = None,
                     mesh: Optional[Mesh] = None
                     ) -> Tuple[Callable, Callable]:
    """(train_step, eval_step) for ``model`` (a ``MultiModel`` at its
    compute dtype) and the optimizer ``tx``. ``augment_fn(batch,
    generator) -> batch`` runs on each train batch before the loss. With
    ``mesh`` the steps take this rank's rows of each global batch (GSPMD's
    semantics, as the module docstring sets out)."""
    note_mbconv_route(model, mesh)
    if mesh is None:
        loss_of = lambda batch: model.loss(buckets=buckets, **batch)
    else:
        loss_of = lambda batch: mesh_multi_loss(model, buckets, mesh, batch)
    return multi_steps(model, tx, loss_of, augment_fn, mesh)


def make_classifier_steps(model: nn.Module, tx: Optimizer,
                          mesh: Optional[Mesh] = None
                          ) -> Tuple[Callable, Callable]:
    """(train_step, eval_step) for a supervised classifier (an
    ``ImageClassifier`` or ``ProfileClassifier`` at its compute dtype):
    the mean cross-entropy of the logits against the batch's ``label``
    ids; the eval step returns ``loss``, the argmax ``pred`` and
    ``label``. BatchNorm statistics update in the train-mode forward, as
    in ``make_multi_steps``. With ``mesh``, GSPMD's semantics; an eval
    batch's rows may then differ in number between the ranks, and a rank
    may have none (an empty dict)."""
    note_mbconv_route(model, mesh)
    spread = mesh is not None and mesh.distributed and mesh.n_data > 1

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   seed: int) -> Tuple[TrainState, torch.Tensor]:
        """One micro-step; returns the updated state and the loss (a
        device scalar)."""
        inputs = {k: v for k, v in batch.items() if k != "label"}
        return _train_update(
            model, tx, state, seed,
            lambda: cross_entropy_loss(model(**inputs), batch["label"]),
            mesh)

    @torch.no_grad()
    def eval_step(state: TrainState,
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if batch:
            label = batch["label"]
            inputs = {k: v for k, v in batch.items() if k != "label"}
            logits = state.load_into(model).eval()(**inputs)
            loss = cross_entropy_loss(logits, label)
            pred = torch.argmax(logits, dim=-1)
        else:  # this rank's share of a small trailing batch
            loss = torch.zeros((), device=mesh.device)
            pred = label = torch.zeros(0, dtype=torch.int64,
                                       device=mesh.device)
        if not spread:  # every rank holds the whole batch
            return {"loss": loss, "pred": pred, "label": label}
        # the mean over every rank's rows: sum(loss × rows) / sum(rows)
        rows = label.shape[0]
        total = torch.stack([loss.float() * rows,
                             torch.tensor(float(rows), device=loss.device)])
        all_reduce_mean_([total], mesh)
        return {"loss": (total[0] / total[1]).to(loss.dtype),
                "pred": gather_uneven(pred, mesh),
                "label": gather_uneven(label.long(), mesh)}

    return train_step, eval_step


class Fitter:
    """Epoch-driven training (the JAX package's ``Fitter``, a Lightning
    ``Trainer`` equivalent): per epoch, every train batch through
    ``train_step(state, batch, seed)``, the mean train loss read on the
    host once, validation every ``check_val_every_n_epoch`` epochs (its
    losses also read once), then ``history``, the writer, the
    ``on_epoch_end`` hook, the checkpointer (any object with ``save(epoch,
    state, metrics)`` and ``wait()``) and early stopping once
    ``min_epochs`` have run. ``put_fn`` places a batch (default: numpy to
    CPU tensors, ``data.pipeline.device_put("cpu")``). With a ``mesh``
    each rank's batches are its shards, and ``samples_per_sec`` counts the
    global batch's rows."""

    def __init__(self, train_step: Callable, eval_step: Callable,
                 writer=None, checkpointer=None, early_stopping=None,
                 min_epochs: int = 1, max_epochs: int = 1,
                 check_val_every_n_epoch: int = 1, seed: int = 0,
                 hooks: Optional[Dict[str, Callable]] = None,
                 put_fn: Optional[Callable] = None,
                 mesh: Optional[Mesh] = None) -> None:
        self.train_step = train_step
        self.mesh = mesh
        self.eval_step = eval_step
        self.put_fn = put_fn or device_put("cpu")
        self.writer = writer
        self.checkpointer = checkpointer
        self.early_stopping = early_stopping
        self.min_epochs = min_epochs
        self.max_epochs = max_epochs
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.seed = seed
        self.hooks = hooks or {}
        self.history: list[Dict[str, float]] = []

    @staticmethod
    def _mean(losses) -> float:
        """One host read for a list of device scalars."""
        if not losses:
            return float("nan")
        return torch.stack(losses).float().mean().item()

    def _eval_epoch(self, state: TrainState, loader) -> Dict[str, float]:
        """``valid_loss``; when the eval step returns ``pred``, also
        ``valid_acc`` and the epoch's ``_pred`` and ``_true`` arrays. The
        device values are read on the host once, after the last batch."""
        losses, preds, labels = [], [], []
        for batch in loader:
            out = self.eval_step(state, self.put_fn(batch))
            losses.append(out["loss"])
            if "pred" in out:
                preds.append(out["pred"].reshape(-1))
                labels.append(out["label"].reshape(-1))
        if not losses:
            return {"valid_loss": float("nan")}
        mean = torch.stack(losses).float().mean().reshape(1)
        flat = torch.cat([mean.double(), *(t.double()
                                           for t in preds + labels)])
        flat = flat.cpu().numpy()
        metrics = {"valid_loss": float(flat[0])}
        if preds:
            n = (len(flat) - 1) // 2
            p = flat[1:1 + n].astype(np.int64)
            t = flat[1 + n:].astype(np.int64)
            metrics["valid_acc"] = float((p == t).mean())
            metrics["_pred"] = p
            metrics["_true"] = t
        return metrics

    def fit(self, state: TrainState, train_loader,
            valid_loader=None) -> TrainState:
        for epoch in range(self.max_epochs):
            t0 = time.monotonic()
            train_losses = []
            n_samples = 0
            for batch in train_loader:
                batch = self.put_fn(batch)
                n_samples += int(next(iter(batch.values())).shape[0]) \
                    * (self.mesh.n_data if self.mesh is not None else 1)
                state, loss = self.train_step(state, batch, self.seed)
                train_losses.append(loss)
            metrics: Dict[str, float] = {
                "train_loss": self._mean(train_losses)}
            if valid_loader is not None and \
                    (epoch + 1) % self.check_val_every_n_epoch == 0:
                metrics.update({k: v for k, v in self._eval_epoch(
                    state, valid_loader).items() if not k.startswith("_")})

            dt = time.monotonic() - t0
            metrics["samples_per_sec"] = n_samples / dt if dt > 0 else 0.0
            self.history.append(dict(metrics, epoch=epoch))
            if self.writer is not None:
                self.writer.log(
                    {k: v for k, v in metrics.items()
                     if k != "samples_per_sec"}, step=epoch)
            if "on_epoch_end" in self.hooks:
                self.hooks["on_epoch_end"](epoch, state, metrics)
            if self.checkpointer is not None:
                self.checkpointer.save(epoch, state, metrics)

            if self.early_stopping is not None and \
                    epoch + 1 >= self.min_epochs:
                monitor_val = metrics.get(self.early_stopping.monitor)
                if monitor_val is not None and \
                        self.early_stopping.update(monitor_val):
                    break
        if self.checkpointer is not None:
            self.checkpointer.wait()
        return state
