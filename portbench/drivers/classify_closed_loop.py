"""Closed-loop classification by one client: batches of query pairs as
host numpy arrays through the served retrieval classifier, classes back
as numpy, the next batch once the last has come back.

Set-up builds the card's model at its compute dtype with the card's
kernel flags, loads weights made from the seed (a card with BatchNorm
takes running statistics from one float32 pass of the reference over a
calibration batch, as a served model's describe the data it sees),
embeds the labelled gallery with it (``retrieval/encode.py``
``encode_batches``), exports the classifier with the fused gallery held
in the program (``retrieval/export.py`` ``export_retrieval_inference``,
k and the batch pinned as the traffic gives them) and serves it as a
``ServingModel``; it makes the traffic's pool of distinct query batches
on the host and warms the program on two of them.

The window calls ``ServingModel.call`` on the pool in turn until
``seconds`` have passed: pairs/s is every query pair whose class came
back over the window's time, the tail the traffic's percentile of every
call's time from the arrays handed over to the classes back. A seeded
reservoir keeps the outputs of ``sample_batches`` calls. With
``--trace 1`` a profiled sub-window of ``trace_batches`` calls follows.

After the window the reference embeds the gallery again from its inputs
and the sampled queries, in float32, and runs its own kNN
(``reference/multi.py``).
"""

from __future__ import annotations

import gc
from time import perf_counter as now
from typing import Dict, List

import numpy as np
import torch

from ..harness import compare, inputs
from ..harness.runner import Record, RunOutput
from ..harness.trace import profile_window
from ..harness.weights import make_weights
from ..reference import multi as ref
from ..reference.precision import strict_f32

GALLERY_LABELS, GALLERY, QUERY_LABELS, QUERIES, CALIBRATION, SAMPLE = \
    range(10, 16)  # seed streams


def gallery_chunks(card: Dict, traffic: Dict, seed: int, device):
    """The gallery's pairs in chunks of the traffic's batch, each made
    from its own stream (so the reference can make them again), and all
    labels."""
    classes, n, step = traffic["classes"], traffic["gallery_pairs"], \
        traffic["batch"]
    labels = inputs.long_tailed_labels(n, classes,
                                       inputs.rng(seed, GALLERY_LABELS))
    size = card.get("target_size", 224)
    kind = card["profile_encoder_args"]["kind"]

    def chunks():
        for j, i in enumerate(range(0, n, step)):
            yield inputs.pairs(labels[i:i + step], classes, size, kind,
                               seed, GALLERY, j, device=device)
    return labels, chunks


def query_pool(card: Dict, traffic: Dict, seed: int, device) -> List[Dict]:
    size = card.get("target_size", 224)
    kind = card["profile_encoder_args"]["kind"]
    classes, n = traffic["classes"], traffic["batch"]
    pool = []
    for i in range(traffic["pool"]):
        labels = inputs.long_tailed_labels(
            n, classes, inputs.rng(seed, QUERY_LABELS, i))
        batch = inputs.pairs(labels, classes, size, kind, seed, QUERIES, i,
                             device=device)
        pool.append({k: v.cpu().numpy() for k, v in batch.items()})
    return pool


def calibration_batch(card: Dict, traffic: Dict, seed: int, device):
    classes = traffic["classes"]
    labels = inputs.long_tailed_labels(traffic["calibration_pairs"], classes,
                                       inputs.rng(seed, CALIBRATION))
    return inputs.pairs(labels, classes, card.get("target_size", 224),
                        card["profile_encoder_args"]["kind"], seed,
                        CALIBRATION, 1, device=device)


def has_batchnorm(card: Dict) -> bool:
    return card["image_encoder_args"]["name"].startswith("efficientnet") \
        or card["profile_encoder_args"]["kind"] == "cnn"


def run(cell, seed: int, seconds: float, trace: bool, device,
        t0: float, ranges=()) -> RunOutput:
    from multimodal_plankton_recognition_torch.config import ModelCard
    from multimodal_plankton_recognition_torch.models.build import \
        build_multi_model
    from multimodal_plankton_recognition_torch.retrieval.encode import \
        encode_batches
    from multimodal_plankton_recognition_torch.retrieval.export import (
        ServingModel, batch_spec, export_retrieval_inference)

    phases = {"imports": now() - t0}
    traffic, card_d = cell.traffic, cell.config["card"]
    card = ModelCard.from_dict(card_d)
    batch = traffic["batch"]
    weights = make_weights(card_d, seed, device)
    if has_batchnorm(card_d):
        with strict_f32():
            weights = ref.calibrate(card_d, weights, calibration_batch(
                card_d, traffic, seed, device))
    model = build_multi_model(card).to(device)
    model.load_state_dict(weights)
    model.eval()
    phases["model"] = now() - t0
    labels, chunks = gallery_chunks(card_d, traffic, seed, device)
    gallery = encode_batches(model, chunks(), device)
    phases["gallery"] = now() - t0
    programs = export_retrieval_inference(
        model, card, gallery["image"], gallery["profile"], labels,
        n_classes=traffic["classes"], k=traffic["k"],
        platforms=(device.type,), batch_size=batch)
    spec = {k: {"shape": list(s), "dtype": d}
            for k, (s, d) in batch_spec(card, "multi").items()}
    serving = ServingModel(programs[device.type], {"input_spec": spec},
                           device)
    del model, programs, gallery
    phases["export"] = now() - t0
    pool = query_pool(card_d, traffic, seed, device)
    pool_n = len(pool)
    phases["queries"] = now() - t0
    for i in range(traffic["warm_batches"]):
        serving.call(pool[i % pool_n])
    setup_s = phases["warm_calls"] = now() - t0

    keep = traffic["sample_batches"]
    sampler = inputs.rng(seed, SAMPLE)
    sample: List = []  # (pool index, outputs)
    latencies, failed, calls, at = [], 0, 0, 0
    start = now()
    while True:
        t = now()
        out = serving.call(pool[at % pool_n])
        latencies.append(now() - t)
        failed += not _sound(out, traffic["classes"])
        # reservoir: every call kept with the same chance
        if len(sample) < keep:
            sample.append((at % pool_n, out))
        else:
            j = int(sampler.integers(0, calls + 1))
            if j < keep:
                sample[j] = (at % pool_n, out)
        calls += 1
        at += 1
        if now() - start >= seconds:
            break
    wall = now() - start
    record = Record(kind="classify", card=card_d, batch=batch, buckets=1,
                    units=calls, wall_s=wall,
                    gallery_rows=2 * traffic["gallery_pairs"])
    if "padding_mask" in pool[0]:
        record.profile_keys = float(np.mean(
            [(~b["padding_mask"]).sum(1).mean() for b in pool]))
    if trace:
        k = traffic["trace_batches"]

        def calls_fn():
            nonlocal at
            for _ in range(k):
                serving.call(pool[at % pool_n])
                at += 1

        record.trace = profile_window(calls_fn, ranges,
                                      device.type == "cuda")
        record.trace_units = k
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    del serving
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with strict_f32():
        numbers = check(card_d, traffic, weights, labels, chunks, pool,
                        sample, device)
    p = traffic["percentile"]
    return RunOutput(
        end_to_end={"classify_pairs_per_s": calls * batch / wall,
                    "classify_p95_ms": float(np.percentile(latencies, p))
                    * 1e3,
                    "setup_s": setup_s},
        attempted=calls, failed=failed, numbers=numbers,
        memory_peak_bytes=peak, record=record, phases=phases)


def _sound(out: Dict[str, np.ndarray], classes: int) -> bool:
    """A call answered: finite embeddings and votes, a class id for every
    row, each the winner of its own row's votes (ties to the smaller
    id)."""
    c, votes = out.get("class_id"), out.get("votes")
    return c is not None and votes is not None and c.size > 0 and bool(
        (c >= 0).all() and (c < classes).all()
        and votes.shape == (c.shape[0], classes)
        and np.isfinite(votes).all()
        and (votes.argmax(1) == c).all()
        and np.isfinite(out["image_emb"]).all()
        and np.isfinite(out["profile_emb"]).all())


def reference_votes(card: Dict, traffic: Dict, weights, labels, chunks,
                    batches: List[Dict], device, prec=ref.F32):
    """The reference's gallery from its inputs, then its (image, profile)
    embeddings and kNN votes (B, classes) of each host batch."""
    g_img, g_prof = ref.embed(card, weights, chunks(), prec)
    ids = torch.as_tensor(np.tile(labels, 2), device=device)
    gallery = torch.cat([g_img, g_prof])
    del g_img, g_prof
    embs, votes = [], []
    for host in batches:
        batch = {k: torch.as_tensor(v).to(device) for k, v in host.items()}
        e = ref.embed(card, weights, [batch], prec)
        embs.append(e)
        votes.append(ref.knn_votes(e, gallery, ids, traffic["classes"],
                                   traffic["k"]))
    return embs, votes


def check(card: Dict, traffic: Dict, weights, labels, chunks, pool, sample,
          device) -> Dict[str, float]:
    """The numbers that compare the served outputs of the sampled calls
    with the reference's."""
    embs, votes = reference_votes(card, traffic, weights, labels, chunks,
                                  [pool[i] for i, _ in sample], device)
    return compare.classify_numbers([out for _, out in sample], embs, votes)


def control_numbers(cell, seed: int, device, prec) -> Dict[str, float]:
    """The same numbers with the reference at ``prec`` in the program's
    place, on the pool's first ``sample_batches`` batches."""
    traffic, card = cell.traffic, cell.config["card"]
    with strict_f32():
        weights = make_weights(card, seed, device)
        if has_batchnorm(card):
            weights = ref.calibrate(card, weights, calibration_batch(
                card, traffic, seed, device))
        labels, chunks = gallery_chunks(card, traffic, seed, device)
        pool = query_pool(card, traffic, seed, device)
        batches = pool[:traffic["sample_batches"]]
        embs, votes = reference_votes(card, traffic, weights, labels, chunks,
                                      batches, device)
        c_embs, c_votes = reference_votes(card, traffic, weights, labels,
                                          chunks, batches, device, prec)
    served = [{"class_id": v.argmax(1).cpu().numpy(),
               "votes": v.cpu().numpy(),
               "image_emb": e[0].cpu().numpy(),
               "profile_emb": e[1].cpu().numpy()}
              for e, v in zip(c_embs, c_votes)]
    return compare.classify_numbers(served, embs, votes)
