"""Two ranks of a gloo process group on the CPU for the port's parallel
tests, and the work they run.

``Ranks(world, directory)`` starts ``world`` Python processes that join
one gloo group through a ``file://`` rendezvous in ``directory`` (a
test's own temporary directory, so xdist's workers never share one) and
then serve calls over a localhost connection: ``ranks.run("name",
*args)`` runs ``name`` of this module on every rank with the same
arguments and returns the ranks' results in rank order. Each rank runs
PyTorch on one thread (``torch_threads``). The work below imports
PyTorch and the port only (no JAX): the test modules hold the results
against JAX in their own process.
"""

from __future__ import annotations

import os
import secrets
import subprocess
import sys
import traceback
from multiprocessing.connection import Client, Listener
from pathlib import Path

import numpy as np

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent


def serve(address, authkey: bytes, rank: int, world: int,
          init: str) -> None:
    """A rank's loop: join the group, then run the calls it is sent."""
    import torch
    import torch.distributed as dist
    from torch_threads import single_thread

    conn = Client(tuple(address), authkey=authkey)
    conn.send(rank)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        with single_thread():
            while True:
                msg = conn.recv()
                if msg is None:
                    return
                name, args, kwargs = msg
                try:
                    conn.send(("ok", globals()[name](*args, **kwargs)))
                except BaseException:  # sent to the test, which raises it
                    conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()


class Ranks:
    def __init__(self, world: int, directory: Path) -> None:
        authkey = secrets.token_bytes(16)
        init = f"file://{Path(directory).resolve() / 'rendezvous'}"
        with Listener(("127.0.0.1", 0), authkey=authkey) as listener:
            code = (f"import sys; sys.path[:0] = [{str(TESTS)!r}, "
                    f"{str(REPO)!r}]; import torch_ranks; "
                    f"torch_ranks.serve({listener.address!r}, "
                    f"{authkey!r}, int(sys.argv[1]), {world}, {init!r})")
            env = dict(os.environ, OMP_NUM_THREADS="1")
            self.procs = [subprocess.Popen([sys.executable, "-c", code,
                                            str(r)], cwd=REPO, env=env)
                          for r in range(world)]
            conns = {}
            for _ in range(world):
                conn = listener.accept()
                conns[conn.recv()] = conn
        self.conns = [conns[r] for r in range(world)]

    def run(self, name: str, *args, **kwargs) -> list:
        for conn in self.conns:
            conn.send((name, args, kwargs))
        out = [conn.recv() for conn in self.conns]
        errors = [msg for status, msg in out if status == "error"]
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
        return [value for _, value in out]

    def close(self) -> None:
        for conn in self.conns:
            conn.send(None)
            conn.close()
        for proc in self.procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def _np(tree):
    """Tensors in ``tree`` (dicts, lists, tuples) as numpy arrays."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree


def _mesh():
    from multimodal_plankton_recognition_torch.parallel.mesh import (
        create_mesh,
    )

    return create_mesh(device="cpu")


# ---- the work ------------------------------------------------------------

def global_loss(method: str, image: np.ndarray, profile: np.ndarray,
                scale: float, bias: float) -> dict:
    """This rank's rows of the global batch through the global loss with
    ``reduce=False``, its backward, and the ``reduce=True`` value."""
    import torch
    from multimodal_plankton_recognition_torch.parallel.contrastive import (
        global_clip_loss, global_siglip_loss,
    )
    from multimodal_plankton_recognition_torch.parallel.mesh import (
        shard_batch,
    )

    mesh = _mesh()
    rows = shard_batch({"i": image, "p": profile}, mesh)
    i = torch.tensor(rows["i"], requires_grad=True)
    p = torch.tensor(rows["p"], requires_grad=True)
    s = torch.tensor(scale, requires_grad=True)
    b = torch.tensor(bias, requires_grad=True)

    def loss(reduce):
        if method == "clip":
            return global_clip_loss(i, p, s, mesh, reduce=reduce)
        return global_siglip_loss(i, p, s, b, mesh, reduce=reduce)

    local = loss(False)
    local.backward()
    return _np({"local": local, "reduced": loss(True).detach(),
                "i": i.grad, "p": p.grad, "scale": s.grad,
                "bias": b.grad if b.grad is not None else torch.zeros(())})


def sharded_knn(gallery: np.ndarray, queries: np.ndarray, k: int) -> dict:
    """``sharded_topk_euclidean`` on this rank's shard; with ``k`` above
    the real rows, the error's message."""
    from multimodal_plankton_recognition_torch.parallel.knn import (
        shard_gallery, sharded_topk_euclidean,
    )

    mesh = _mesh()
    sg = shard_gallery(gallery, mesh)
    try:
        idx, dist = sharded_topk_euclidean(queries, sg, k, mesh)
    except ValueError as e:
        return {"error": str(e)}
    return {"idx": idx, "dist": dist, "shard": tuple(sg.rows.shape)}


def knn_predict(gallery: np.ndarray, labels: np.ndarray,
                queries: tuple, ks: tuple) -> dict:
    from multimodal_plankton_recognition_torch.ops.knn import ANNClassifier

    clf = ANNClassifier(gallery, labels, "cpu", sharded=True)
    return clf.predict_many(*queries, ks=ks)


def suite(embeddings: dict, mode: str, N, K, repeats: int, th: int,
          sharded: bool) -> dict:
    from multimodal_plankton_recognition_torch.retrieval import benchmark

    try:
        return benchmark.run_suite(embeddings, mode, N, K, repeats, th=th,
                                   sharded=sharded, device="cpu")
    finally:
        benchmark.set_sharded_retrieval(False)


def multi_step(model_args: dict, init: dict, batch: dict, mode: str,
               negatives: str, buckets: int, optim: dict,
               steps: int = 1, fused_calls: bool = False) -> dict:
    """``steps`` train steps of an f32 ``MultiModel`` from ``init`` on
    this rank's rows of ``batch``, in ``mode`` ("gspmd" or "shard_map"),
    then one eval step: the losses, the masters, the momentum buffers and
    the BatchNorm statistics after them; with ``fused_calls``, also the
    calls of the fused MBConv route and what the steps printed."""
    import contextlib
    import io

    from multimodal_plankton_recognition_torch.models.image import (
        efficientnet,
    )

    calls = []
    real = efficientnet._MBConv._fused

    def counted(self, x):
        calls.append(1)
        return real(self, x)

    printed = io.StringIO()
    efficientnet._MBConv._fused = counted
    try:
        with contextlib.redirect_stdout(printed):
            out = _multi_step(model_args, init, batch, mode, negatives,
                              buckets, optim, steps)
    finally:
        efficientnet._MBConv._fused = real
    if fused_calls:
        out.update(fused_calls=len(calls), printed=printed.getvalue())
    return out


def _multi_step(model_args, init, batch, mode, negatives, buckets, optim,
                steps):
    import torch
    from multimodal_plankton_recognition_torch.config import OptimConfig
    from multimodal_plankton_recognition_torch.models.multi import (
        MultiModel,
    )
    from multimodal_plankton_recognition_torch.parallel.mesh import (
        shard_batch,
    )
    from multimodal_plankton_recognition_torch.train import (
        create_train_state, make_multi_steps, make_multi_steps_shard_map,
        make_optimizer,
    )

    mesh = _mesh()
    model = MultiModel(dtype=torch.float32, **model_args)
    tx = make_optimizer(OptimConfig(**optim))
    state = create_train_state(
        model, {k: torch.as_tensor(v) for k, v in init.items()}, tx)
    if mode == "shard_map":
        train_step, eval_step = make_multi_steps_shard_map(
            model, tx, mesh, buckets=buckets, negatives=negatives)
    else:
        train_step, eval_step = make_multi_steps(
            model, tx, 1 if negatives == "global" else buckets, mesh=mesh)
    local = {k: torch.as_tensor(v)
             for k, v in shard_batch(batch, mesh).items()}
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, local, 0)
        losses.append(float(loss))
    return _np({"losses": losses,
                "eval": float(eval_step(state, local)["loss"]),
                "params": state.params,
                "momentum": {n: state.opt.state[m]["momentum_buffer"]
                             for n, m in state.params.items()},
                "batch_stats": dict(state.batch_stats)})


def drive(kind: str, dataset: str, card: dict, logdir: str,
          max_epochs=None, resume=None, capture: bool = False) -> dict:
    """``train_multi`` / ``train_image`` on the CPU: the history, the run
    directory, the best step, the final masters and, with ``capture``,
    what the driver printed."""
    import contextlib
    import io

    from multimodal_plankton_recognition_torch import config
    from multimodal_plankton_recognition_torch.train import drivers

    fn = {"multi": drivers.train_multi, "image": drivers.train_image,
          "profile": drivers.train_profile}[kind]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed) if capture \
            else contextlib.nullcontext():
        out = fn(dataset, config.ModelCard.from_dict(card), logdir=logdir,
                 max_epochs=max_epochs, resume=resume, device="cpu")
    result = {"history": out["history"], "logdir": out["logdir"],
              "best_step": out["best_step"],
              "params": _np(out["state"].params),
              "printed": printed.getvalue()}
    if "test_acc" in out:
        result["test_acc"] = out["test_acc"]
    return result


def refusal(kind: str, dataset: str, card: dict, logdir: str) -> str:
    """The message a driver raises with on this rank."""
    try:
        drive(kind, dataset, card, logdir)
    except ValueError as e:
        return str(e)
    return ""


def mesh_collectives() -> dict:
    """``create_mesh``, ``shard_batch``, ``replicate_state`` from states
    that differ by rank, ``gather_uneven`` of 3 rows on rank 0 and none on
    rank 1, and ``make_global_batch`` with equal and unequal rows."""
    import torch
    import torch.distributed as dist
    from multimodal_plankton_recognition_torch.parallel import multihost
    from multimodal_plankton_recognition_torch.parallel.mesh import (
        gather_uneven, replicate_state, shard_batch,
    )
    from multimodal_plankton_recognition_torch.train.state import TrainState

    mesh = _mesh()
    rank = dist.get_rank()
    shard = shard_batch({"x": np.arange(12).reshape(6, 2)}, mesh)["x"]
    master = torch.full((3,), float(rank + 1))
    opt = torch.optim.SGD([master], lr=0.1, momentum=0.9)
    opt.state[master]["momentum_buffer"] = torch.full((3,), 10.0 * rank)
    state = TrainState(step=7 if rank == 0 else 3, params={"w": master},
                       opt=opt, batch_stats={"s": torch.full((2,),
                                                             -1.0 - rank)})
    state = replicate_state(state, mesh)
    uneven = gather_uneven(torch.arange(3) if rank == 0
                           else torch.zeros(0, dtype=torch.int64), mesh)
    rows = multihost.make_global_batch({"x": np.zeros((2, 1))}, mesh)
    try:
        multihost.make_global_batch({"x": np.zeros((1 + rank, 1))}, mesh)
        mismatch = ""
    except ValueError as e:
        mismatch = str(e)
    return {"mesh": {"n_data": mesh.n_data, "n_model": mesh.n_model,
                     "rank": mesh.rank, "data_index": mesh.data_index},
            "shard": shard, "step": state.step, "master": _np(master),
            "momentum": _np(opt.state[master]["momentum_buffer"]),
            "stat": _np(state.batch_stats["s"]), "uneven": _np(uneven),
            "global_rows": rows["x"].shape[0] * mesh.n_data,
            "mismatch": mismatch}


def classifier_eval(image_args: dict, init: dict, batch: dict,
                    split: tuple) -> dict:
    """The classifier's eval step on this rank's rows of ``batch`` split
    ``split`` (rows of rank 0, rank 1, ...; none gives the empty ``{}``):
    its loss, preds and labels (every rank's, gathered)."""
    import torch
    import torch.distributed as dist
    from multimodal_plankton_recognition_torch.config import OptimConfig
    from multimodal_plankton_recognition_torch.models.classifier import (
        ImageClassifier,
    )
    from multimodal_plankton_recognition_torch.train import (
        create_train_state, make_classifier_steps, make_optimizer,
    )

    rank = dist.get_rank()
    model = ImageClassifier(n_classes=3, image_encoder_args=image_args,
                            dtype=torch.float32)
    tx = make_optimizer(OptimConfig())
    state = create_train_state(
        model, {k: torch.as_tensor(v) for k, v in init.items()}, tx)
    _, eval_step = make_classifier_steps(model, tx, _mesh())
    start = sum(split[:rank])
    local = {k: torch.as_tensor(v[start:start + split[rank]])
             for k, v in batch.items()} if split[rank] else {}
    return _np(eval_step(state, local))
