"""The train drivers behind ``scripts/train_multi_torch.py``,
``scripts/train_image_torch.py`` and ``scripts/train_profile_torch.py``
(``train_multi``, ``train_image`` and ``train_profile`` of the JAX
package's ``train/drivers.py``).

The file contracts are the JAX driver's: ``<dataset>/train.csv`` and
``<dataset>/test.csv`` in (or their packed caches, ``packed_cache:
true``), ``<logdir>/<card>_<dataset>/version_k/`` out, with
``metrics.jsonl``, ``checkpoints/`` (the port's format,
``train.checkpoint``) and, under ``--profile``, a trace of the first
epoch in ``profile/``. The steps are the card's: ``build_multi_model``,
f32 masters from a seeded init (``models.initializers``: the Flax
initialisers' distributions, drawn from ``card.seed``; no sample batch),
``make_multi_steps`` at ``step_buckets`` with the card's device
augmentation, ``Fitter`` with top-k checkpoints on ``valid_loss`` and
early stopping. On a card the loaders pin each batch on their producer
thread and the steps read it through a non-blocking copy
(``data.pipeline.PinnedCollate``, ``device_put``).

The supervised classifiers (``_train_classifier``) train on their eval
pipeline's raw transforms (``ImageTransforms``, ``ProfileTransform``:
``retrieval.encode.eval_pipeline``) with the pair augmentation, validate
on the test split in order, keep the top-k checkpoints by ``valid_acc``
(max), stop early on ``valid_loss``, then restore the best checkpoint
for the final test: ``test_acc``, and the confusion matrix as the
``test_cm`` image where the writer has a TensorBoard sink.

``pretrained: true`` with a ``pretrained_path`` merges that npz into the
initial masters and running statistics before the train state is made
(``models.pretrained.load_pretrained_into``; JAX's
``_maybe_load_pretrained``), printing JAX's counts; without a path it
prints JAX's message and trains from scratch. A resumed run takes its
weights from the checkpoint instead.

Several cards: launched under ``torchrun --nproc_per_node N``, the
drivers start the process group (``parallel.multihost.initialize``) and
train on a mesh of N ranks (``_setup_mesh``, JAX's): ``n_data`` is the
world over the card's ``mesh: {model: ...}`` (default 1), a card's
``mesh: {data: ...}`` must equal it, and ``card.bs`` must divide by it
(JAX's message, naming a process count that divides; JAX would leave
chips idle instead). Each rank loads its contiguous slice of every
global batch (``Loader(host_shard=...)``), starts from rank 0's state
(``replicate_state``; a resume loads on every rank first) and runs
``make_multi_steps(..., mesh=...)`` (GSPMD's semantics) or, for
``parallel: shard_map`` on more than one rank, the per-rank step
(``train.shard_step``; a BatchNorm model raises JAX's error, and
bucketed negatives whose buckets do not divide by the data ranks print
JAX's line and take the GSPMD step). Only rank 0 writes the run
directory, ``metrics.jsonl``, the checkpoints and the trace; every rank
waits on a barrier after a save. The metrics are all-reduced in the
steps, so early stopping and the top-k choice take the same branch on
every rank. The classifiers' eval covers every test row: the trailing
partial batch is split over the ranks (``split_tail``), where JAX
replicates it.

``loader: grain`` loads in worker processes
(``data.grain_pipeline.GrainLoader``) in all three drivers, also per
rank (``host_shard``): the workers collate, the parent pins
(``pin_memory``); ``loader: threads`` (the default) is ``Loader`` with
``PinnedCollate``.

Not ported, as TPU machinery: ``use_tpu_runtime_flags``,
``enable_compilation_cache`` and ``use_fast_prng``. ``parallel:
shard_map`` on one device is the plain step, as in JAX.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..config import ModelCard, load_card
from ..data.dataset import MultiSet
from ..data.grain_pipeline import GrainLoader
from ..data.pipeline import (
    Loader, PinnedCollate, device_put, image_collate_fn, multi_collate_fn,
    profile_collate_fn,
)
from ..data.tokenize import get_tokenizer
from ..data.transforms import (
    ImageTransformOversize, ImageTransformTrain, PairAugmentation,
    ProfileTransformOversize, ProfileTransformTrain,
)
from ..models.build import build_for_kind, step_buckets
from ..models.initializers import init_weights_
from ..models.pretrained import load_pretrained_into
from ..ops.augment import multi_train_augment
from ..ops.knn import require_device
from ..parallel import multihost
from ..parallel.mesh import (
    Mesh, barrier, broadcast_object, create_mesh, replicate_state,
)
from ..retrieval.encode import eval_pipeline
from ..utils import LabelVocab
from .checkpoint import CheckpointManager, read_port_metadata
from .early_stopping import EarlyStopping
from .logging import MetricsWriter
from .loop import Fitter, make_classifier_steps, make_multi_steps
from .metrics import confusion_matrix, render_confusion_matrix
from .optim import Optimizer, make_optimizer
from .shard_step import (
    BATCHNORM_REFUSAL, has_batchnorm, make_multi_steps_shard_map,
)
from .state import TrainState, create_train_state

TRACE_FILE = "epoch_0.pt.trace.json"


def _run_name(card_name: str, data_path: Path) -> str:
    """``<card name>_<the data path's last two parts>``."""
    parts = [p for p in data_path.parts if p not in (".", "..", "/")]
    return card_name + "_" + "_".join(parts[-2:])


def _close(*loaders) -> None:
    """Stop the worker processes of the loaders that have them."""
    for loader in loaders:
        if isinstance(loader, GrainLoader):
            loader.close()


def _make_loader(card: ModelCard, dataset, collate, pin: bool, **kwargs):
    """The card's loader over ``dataset`` in batches of ``card.bs`` with
    ``card.num_workers`` (JAX's ``_loader_cls``: ``loader: grain``, worker
    processes, else the threaded ``Loader``); ``pin``: batches in
    page-locked memory (``Loader``: on its producer thread;
    ``GrainLoader``: in the parent, never in a worker)."""
    if card.loader == "grain":
        return GrainLoader(dataset, card.bs, collate,
                           num_workers=card.num_workers, pin_memory=pin,
                           **kwargs)
    return Loader(dataset, card.bs, PinnedCollate(collate) if pin
                  else collate, num_workers=card.num_workers, **kwargs)


def _setup_mesh(card: ModelCard, device: torch.device) -> Mesh:
    """The run's mesh (JAX's ``_setup_mesh``): the process group the
    launcher describes, started here if it is not up yet (one process
    without a launcher), split into ``n_data`` = world / ``model``. A
    card's ``mesh: {data: ...}`` must match, and ``card.bs`` divide by
    ``n_data``; otherwise this raises, naming a process count that
    fits."""
    multihost.initialize(device=device)
    cfg = card.mesh or {}
    n_model = cfg.get("model") or 1
    world = multihost.process_count()
    n_data = cfg.get("data")
    if n_data is None:
        n_data = max(1, world // n_model)
    if n_data * n_model != world:
        raise ValueError(
            f"mesh {cfg} asks for {n_data} x {n_model} = {n_data * n_model}"
            f" processes, and this run has {world}; launch it with torchrun "
            f"--nproc_per_node {n_data * n_model}")
    if card.bs % n_data != 0:
        fits = max(d for d in range(1, n_data + 1) if card.bs % d == 0)
        raise ValueError(
            f"Batch size {card.bs} not divisible by data-axis size "
            f"{n_data}; launch torchrun --nproc_per_node {fits * n_model}, "
            f"whose data axis divides it")
    return create_mesh(n_data, n_model, device)


class _RankCheckpointer:
    """Rank 0's ``CheckpointManager`` seen from every rank: rank 0 writes
    (the state is the same on every rank), every rank waits on a barrier
    after a save, and ``best_step`` is rank 0's."""

    def __init__(self, mesh: Mesh, manager: Optional[CheckpointManager]):
        self.mesh = mesh
        self.manager = manager

    def save(self, epoch: int, state, metrics: Dict[str, float]) -> bool:
        saved = self.manager is not None and \
            self.manager.save(epoch, state, metrics)
        barrier(self.mesh)
        return saved

    def wait(self) -> None:
        if self.manager is not None:
            self.manager.wait()
        barrier(self.mesh)

    def best_step(self) -> Optional[int]:
        return broadcast_object(
            self.manager.best_step() if self.manager is not None else None,
            self.mesh)

    def restore(self, step: int) -> Dict[str, Any]:
        return self.manager.restore(step)


def multi_datasets(card: ModelCard, data_path: Path | str):
    """(train set, test set) of the JAX driver's three branches: the
    packed caches; the CSV path with the oversize prefixes (device
    augmentation); the CSV path with the random train transforms and the
    pair augmentation."""
    data_path = Path(data_path)
    ts = card.target_size
    if card.packed_cache:
        from ..data.packed import PackedMultiSet

        return (PackedMultiSet(data_path / "train.csv", ts,
                               device_augment=card.device_augment),
                PackedMultiSet(data_path / "test.csv", ts))
    if card.device_augment:
        train_set = MultiSet(data_path / "train.csv",
                             ImageTransformOversize(ts),
                             ProfileTransformOversize(ts))
    else:
        train_set = MultiSet(data_path / "train.csv", ImageTransformTrain(ts),
                             ProfileTransformTrain(ts), PairAugmentation())
    image_tf, profile_tf, _ = eval_pipeline(card, "multi")
    return train_set, MultiSet(data_path / "test.csv", image_tf, profile_tf)


def multi_loaders(card: ModelCard, train_set, test_set,
                  device: torch.device | str,
                  mesh: Optional[Mesh] = None) -> Tuple[Loader, Loader]:
    """The driver's train and valid loaders of the card's ``loader`` (both
    shuffled, last partial batch dropped; seeds ``card.seed`` and
    ``card.seed + 1``) on
    the eval pipeline's tokenizer; under device augmentation the train
    tokenizer pads to the oversize, where the step crops. ArcFace batches carry class ids, and the card's
    head gets ``out_features`` from the train classes. On a card the
    batches come pinned; with a ``mesh``, each rank's slice of them."""
    valid_tok = eval_pipeline(card, "multi")[2]
    train_tok = valid_tok
    if card.device_augment:
        train_tok = get_tokenizer("cnn", card.target_size,
                                  pad_to=card.oversize)
    coord = card.coordination_args or {}
    vocab = None
    if coord.get("method") == "arcface":
        vocab = LabelVocab(train_set.class_names)
        coord.setdefault("out_features", len(vocab))
    pin = torch.device(device).type == "cuda"

    def loader(dataset, tokenizer, seed):
        return _make_loader(card, dataset, multi_collate_fn(tokenizer, vocab),
                            pin, shuffle=True, drop_last=True, seed=seed,
                            host_shard=mesh.host_shard() if mesh else None)

    return (loader(train_set, train_tok, card.seed),
            loader(test_set, valid_tok, card.seed + 1))


def init_masters(card: ModelCard, kind: str = "multi",
                 class_names: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """The f32 initial weights (and BatchNorm statistics) of the card's
    model of ``kind`` (``build_for_kind``) as a state dict on the CPU,
    drawn from ``card.seed``."""
    model = build_for_kind(card, kind, class_names, dtype=torch.float32)
    return init_weights_(model,
                         torch.Generator().manual_seed(card.seed)).state_dict()


def _maybe_load_pretrained(card: ModelCard, masters: Dict[str, torch.Tensor],
                          kind: str = "multi",
                          class_names: Sequence[str] = ()
                          ) -> Dict[str, torch.Tensor]:
    """``masters`` (a state dict of the card's model of ``kind``) with the
    card's ``pretrained_path`` npz merged in when the card asks for
    pretrained weights, as the JAX driver's ``_maybe_load_pretrained``:
    printing the load's counts, or, with no path, JAX's message, and then
    ``masters`` as they are."""
    args = card.image_encoder_args or {}
    if not args.get("pretrained"):
        return masters
    path = args.get("pretrained_path")
    if not path:
        print("pretrained: true but no pretrained_path given; "
              "training from scratch (produce an npz with "
              "scripts/convert_timm_torch.py)")
        return masters
    model = build_for_kind(card, kind, class_names, dtype=torch.float32)
    model.load_state_dict(masters, strict=True)
    merged, stats = load_pretrained_into(model, path)
    print(f"loaded pretrained weights from {path}: {stats}")
    return merged


def multi_state(card: ModelCard, device: torch.device | str,
                resume: Optional[str | Path] = None, kind: str = "multi",
                class_names: Sequence[str] = ()
                ) -> Tuple[torch.nn.Module, Optimizer, TrainState]:
    """(model of ``kind`` on ``device`` at the card's compute dtype,
    optimizer, train state): f32 masters from ``init_masters`` and the
    card's pretrained npz (``_maybe_load_pretrained``), or, with
    ``resume``, the latest step kept in that port checkpoint directory
    (its step, masters, BatchNorm statistics, momentum and pending
    gradient mean)."""
    tx = make_optimizer(card.optim_args,
                        card.trainer_args.accumulate_grad_batches)
    model = build_for_kind(card, kind, class_names).to(device)
    if not resume:
        masters = _maybe_load_pretrained(
            card, init_masters(card, kind, class_names), kind, class_names)
        return model, tx, create_train_state(model, masters, tx)
    read_port_metadata(resume)
    # save_top_k=0 ranks nothing, so the "best" step is the latest one,
    # as the JAX driver's orbax manager without best_fn restores it
    payload = CheckpointManager(resume, save_top_k=0).restore()
    state = create_train_state(
        model, {**payload["params"], **payload["batch_stats"]}, tx)
    state.step = payload["step"]
    state.opt.load_state_dict(payload["opt"])
    if payload["grad_acc"] is not None:
        state.grad_acc = {n: g.to(device)
                          for n, g in payload["grad_acc"].items()}
    return model, tx, state


class _Profiler:
    """torch.profiler over the first epoch, when enabled: started before
    the fit, stopped at the end of epoch 0 (or of the fit), its Chrome
    trace written to ``<directory>/epoch_0.pt.trace.json``."""

    def __init__(self, directory: Path, enabled: bool,
                 device: torch.device) -> None:
        self.directory = directory
        self.enabled = enabled
        self.device = device
        self.prof = None

    def start(self) -> None:
        if not self.enabled:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()

    def stop_after_first_epoch(self, epoch: int, *_) -> None:
        if epoch == 0:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        prof.stop()
        self.directory.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(self.directory / TRACE_FILE))


def _run_outputs(mesh: Mesh, logdir, name: str, monitor: str, mode: str,
                 card: ModelCard, metadata: Dict[str, Any], profile: bool
                 ) -> Tuple[Optional[MetricsWriter], _RankCheckpointer, str,
                            _Profiler]:
    """(writer, checkpointer, run directory, profiler) of a run: rank 0
    makes the run directory, its writer, checkpoints (top-k by
    ``monitor``) and trace; the other ranks get no writer, rank 0's
    checkpointer behind barriers and the directory's name."""
    writer = manager = None
    if mesh.rank == 0:
        writer = MetricsWriter(logdir, name=name)
        manager = CheckpointManager(
            writer.logdir / "checkpoints", monitor=monitor, mode=mode,
            save_top_k=card.save_top_k, metadata=metadata)
    run_dir = broadcast_object(
        str(writer.logdir) if writer is not None else None, mesh)
    profiler = _Profiler(Path(run_dir) / "profile",
                         profile and writer is not None, mesh.device)
    return writer, _RankCheckpointer(mesh, manager), run_dir, profiler


def _card(modelcard: str | Path | ModelCard,
          max_epochs: Optional[int]) -> Tuple[ModelCard, str]:
    """(card, its name for the run directory): a copy of a ``ModelCard``
    (named by its ``name`` key, else "card") or the card at a YAML / JSON
    path (named by the file's stem); ``max_epochs`` overrides the card's."""
    if isinstance(modelcard, ModelCard):
        card = copy.deepcopy(modelcard)
        card_name = card.raw.get("name", "card")
    else:
        card = load_card(modelcard)
        card_name = Path(modelcard).stem
    if max_epochs is not None:
        card.trainer_args.max_epochs = max_epochs
    return card, card_name


def train_multi(dataset: str | Path, modelcard: str | Path | ModelCard,
                logdir: str | Path = "logs",
                max_epochs: Optional[int] = None,
                resume: Optional[str | Path] = None,
                profile: bool = False,
                device: torch.device | str = "cuda") -> Dict[str, Any]:
    """Contrastive cross-modal pretraining from the card ``modelcard`` (a
    YAML or JSON path, or a ``ModelCard``) on the split directory
    ``dataset``, on ``device`` (the card unless the caller names another;
    without a card the default raises). ``max_epochs`` overrides the
    card's; ``resume`` continues from the latest step of a port checkpoint
    directory; ``profile`` traces the first epoch. Returns ``{"history",
    "logdir", "best_step", "state"}``."""
    device = require_device(device)
    card, card_name = _card(modelcard, max_epochs)
    mesh = _setup_mesh(card, device)
    device = mesh.device
    data_path = Path(dataset)

    train_set, test_set = multi_datasets(card, data_path)
    train_loader, valid_loader = multi_loaders(card, train_set, test_set,
                                               device, mesh)
    model, tx, state = multi_state(card, device, resume)
    state = replicate_state(state, mesh)
    augment_fn = None
    if card.device_augment:
        ts = card.target_size
        kind = (card.profile_encoder_args or {}).get("kind", "cnn")
        augment_fn = lambda b, g: multi_train_augment(b, ts, g, kind=kind)
    train_step, eval_step = _multi_steps(card, model, tx, mesh, augment_fn)

    writer, ckpt, run_dir, profiler = _run_outputs(
        mesh, logdir, _run_name(card_name, data_path), "valid_loss", "min",
        card, {"card": card.to_dict(), "kind": "multi",
               "class_names": [str(c) for c in train_set.class_names]},
        profile)
    trainer = card.trainer_args
    fitter = Fitter(train_step, eval_step, writer=writer, checkpointer=ckpt,
                    early_stopping=EarlyStopping("valid_loss", "min",
                                                 card.patience),
                    min_epochs=trainer.min_epochs,
                    max_epochs=trainer.max_epochs,
                    check_val_every_n_epoch=trainer.check_val_every_n_epoch,
                    seed=card.seed, put_fn=device_put(device),
                    hooks={"on_epoch_end": profiler.stop_after_first_epoch},
                    mesh=mesh)
    profiler.start()
    try:
        state = fitter.fit(state, train_loader, valid_loader)
    finally:
        profiler.stop()
        _close(train_loader, valid_loader)
    if writer is not None:
        writer.close()
    return {"history": fitter.history, "logdir": run_dir,
            "best_step": ckpt.best_step(), "state": state}


def _multi_steps(card: ModelCard, model, tx: Optimizer, mesh: Mesh,
                 augment_fn):
    """The card's contrastive steps on ``mesh`` (JAX's choice in
    ``train_multi``): the per-rank step for ``parallel: shard_map`` on
    more than one rank, else ``make_multi_steps`` at ``step_buckets``."""
    buckets = step_buckets(card)
    if card.parallel == "shard_map" and mesh.world > 1:
        if has_batchnorm(model):
            raise ValueError(BATCHNORM_REFUSAL)
        negatives = (card.coordination_args or {}).get("negatives",
                                                         "bucketed")
        try:
            return make_multi_steps_shard_map(
                model, tx, mesh, buckets=card.buckets, negatives=negatives,
                augment_fn=augment_fn)
        except ValueError as e:
            # e.g. buckets that do not divide by the data ranks
            print(f"parallel: shard_map unavailable ({e}); "
                  f"falling back to GSPMD")
    return make_multi_steps(model, tx, buckets, augment_fn=augment_fn,
                            mesh=mesh)


def _train_classifier(kind: str, dataset: str | Path,
                      modelcard: str | Path | ModelCard,
                      logdir: str | Path = "logs",
                      max_epochs: Optional[int] = None,
                      resume: Optional[str | Path] = None,
                      profile: bool = False,
                      device: torch.device | str = "cuda") -> Dict[str, Any]:
    device = require_device(device)
    card, card_name = _card(modelcard, max_epochs)
    mesh = _setup_mesh(card, device)
    device = mesh.device
    data_path = Path(dataset)
    # the raw transforms and the tokenizer the classifier is served with
    image_tf, profile_tf, tokenizer = eval_pipeline(card, kind)
    train_set = MultiSet(data_path / "train.csv", image_tf, profile_tf,
                         PairAugmentation())
    test_set = MultiSet(data_path / "test.csv", image_tf, profile_tf)
    vocab = LabelVocab(train_set.class_names)
    collate = image_collate_fn(vocab) if kind == "image" \
        else profile_collate_fn(tokenizer, vocab)
    pin = device.type == "cuda"
    train_loader = _make_loader(card, train_set, collate, pin, shuffle=True,
                                drop_last=True, seed=card.seed,
                                host_shard=mesh.host_shard())
    test_loader = _make_loader(card, test_set, collate, pin, shuffle=False,
                               drop_last=False, seed=card.seed + 1,
                               host_shard=mesh.host_shard(), split_tail=True)
    model, tx, state = multi_state(card, device, resume, kind,
                                   vocab.to_list())
    state = replicate_state(state, mesh)
    train_step, eval_step = make_classifier_steps(model, tx, mesh)

    writer, ckpt, run_dir, profiler = _run_outputs(
        mesh, logdir, _run_name(card_name, data_path), "valid_acc", "max",
        card, {"card": card.to_dict(), "kind": kind,
               "class_names": vocab.to_list()}, profile)
    trainer = card.trainer_args
    put = device_put(device)
    fitter = Fitter(train_step, eval_step, writer=writer, checkpointer=ckpt,
                    early_stopping=EarlyStopping("valid_loss", "min",
                                                 card.patience),
                    min_epochs=trainer.min_epochs,
                    max_epochs=trainer.max_epochs,
                    check_val_every_n_epoch=trainer.check_val_every_n_epoch,
                    seed=card.seed, put_fn=put,
                    hooks={"on_epoch_end": profiler.stop_after_first_epoch},
                    mesh=mesh)
    profiler.start()
    try:
        state = fitter.fit(state, train_loader, test_loader)
    finally:
        profiler.stop()
        _close(train_loader)

    # the final test on the best checkpoint's masters and statistics,
    # read by rank 0 and broadcast
    best = ckpt.best_step()
    if best is not None:
        if writer is not None:  # rank 0
            payload = ckpt.restore(best)
            with torch.no_grad():
                for name, master in state.params.items():
                    master.copy_(payload["params"][name])
                for name, buf in state.batch_stats.items():
                    buf.copy_(payload["batch_stats"][name])
        state = replicate_state(state, mesh)
    try:
        test = fitter._eval_epoch(state, test_loader)
    finally:
        _close(test_loader)
    test_acc = test["valid_acc"]
    if writer is not None:
        writer.log({"test_acc": test_acc}, step=0)
        if writer.has_tensorboard:
            cm = confusion_matrix(test["_pred"], test["_true"], len(vocab))
            writer.log_image("test_cm",
                             render_confusion_matrix(cm, vocab.to_list()))
        writer.close()
    return {"history": fitter.history, "logdir": run_dir,
            "best_step": best, "test_acc": test_acc, "state": state}


def train_image(dataset: str | Path, modelcard: str | Path | ModelCard,
                logdir: str | Path = "logs", max_epochs: Optional[int] = None,
                resume: Optional[str | Path] = None, profile: bool = False,
                device: torch.device | str = "cuda") -> Dict[str, Any]:
    """Supervised image classifier from the card ``modelcard`` on the
    split directory ``dataset``, on ``device`` (the card unless the caller
    names another; without a card the default raises). Returns
    ``{"history", "logdir", "best_step", "test_acc", "state"}``."""
    return _train_classifier("image", dataset, modelcard, logdir, max_epochs,
                             resume, profile, device)


def train_profile(dataset: str | Path, modelcard: str | Path | ModelCard,
                  logdir: str | Path = "logs",
                  max_epochs: Optional[int] = None,
                  resume: Optional[str | Path] = None, profile: bool = False,
                  device: torch.device | str = "cuda") -> Dict[str, Any]:
    """Supervised profile classifier; as ``train_image``."""
    return _train_classifier("profile", dataset, modelcard, logdir,
                             max_epochs, resume, profile, device)
