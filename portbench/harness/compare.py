"""The numbers that decide ``correct``, each the program's reading
against the plain reference's.

Train cells (the first three steps of the timed train step, against the
reference's three steps from the same weights on the same batches):

* ``loss_gap``: the largest |loss - reference loss| / |reference loss|
  over the steps;
* ``grad_gap``: over the leaves, the largest gap between the norm of the
  first step's gradient as the optimizer got it (its momentum buffer
  after one step, less the weight decay's share) and the reference's,
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger;
* ``change_gap``: the same for the norm of each leaf's change over the
  three steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone);
* ``grad_gap_median``, ``change_gap_median``: the median leaf's gap of
  each, steady from seed to seed where the worst leaf is a sum that
  cancels (BatchNorm's parameters ahead of another BatchNorm, summed
  over every pixel of the batch).

Train cells also judge the dropout of the first step at the card's rate,
tapped there (``reference/dropout.py``): ``attn_drop_var_z``,
``attn_drop_bias_z``, ``drop_share_z``, ``drop_scale_gap``.

Classify cells (sampled batches the timed path served, against the
reference's embeddings of the same pairs and its kNN over the gallery it
embedded itself from the gallery's inputs):

* ``emb_gap``: the largest 1 - cos(served embedding, reference embedding)
  over the rows and both modalities;
* ``votes_gap``: the largest over the rows of Σ |served votes - reference
  votes| over the classes, over Σ reference votes: the kNN's summed
  inverse-distance weights, which carry its distances and its gallery;
* ``vote_mass_gap``: the largest over the rows of |Σ served votes - Σ
  reference votes| / Σ reference votes: the summed inverse distances of
  the k nearest rows of each modality, which a swap between two rows at
  nearly one distance leaves alone;
* ``vote_gap``: the largest share of the reference's winning vote that
  the served class falls short of it by, (V[best] - V[served]) / V[best],
  V the reference's summed inverse-distance weights;
* ``class_mismatch_pct``: the share of sampled rows whose served class is
  not the reference's.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import torch

CLASSIFY_NUMBERS = ("emb_gap", "votes_gap", "vote_mass_gap", "vote_gap",
                    "class_mismatch_pct")
#: a leaf whose reference gradient norm is under this share of the
#: median leaf's is left out of ``change_gap``
STILL_LEAF = 1e-3


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float()))
            for n, t in leaves.items()}


def _median(values: Iterable[float]) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def leaf_gaps(program: Dict[str, torch.Tensor],
              reference: Dict[str, torch.Tensor],
              leave_out: Iterable[str] = ()) -> List[float]:
    """| |p| - |r| | / max(|r|, median leaf |r|) of every leaf."""
    skip = set(leave_out)
    p, r = _norms(program), _norms(reference)
    names = [n for n in r if n not in skip]
    med = _median(r[n] for n in names)
    return [abs(p[n] - r[n]) / max(r[n], med, 1e-30) for n in names]


def still_leaves(grad: Dict[str, torch.Tensor]) -> List[str]:
    norms = _norms(grad)
    med = _median(norms.values())
    return [n for n, v in norms.items() if v < STILL_LEAF * med]


def train_numbers(losses: List[float], grad1: Dict[str, torch.Tensor],
                  change: Dict[str, torch.Tensor], ref: Dict
                  ) -> Dict[str, float]:
    """The numbers of a train cell. ``change``: each leaf's weights
    after the steps minus before; ``ref``: ``reference.multi.
    train_steps``' output and its ``change``."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a)
                   else math.inf for a, b in zip(losses, ref["losses"]))
    grad = leaf_gaps(grad1, ref["grad1"])
    moved = leaf_gaps(change, ref["change"], still_leaves(ref["grad1"]))
    return {"loss_gap": loss_gap,
            "grad_gap": max(grad), "change_gap": max(moved),
            "grad_gap_median": _median(grad),
            "change_gap_median": _median(moved)}


def classify_numbers(served: List[Dict], ref_emb: List[tuple],
                     ref_votes: List[torch.Tensor]) -> Dict[str, float]:
    """``served``: the program's outputs of the sampled batches
    (``class_id``, ``votes``, ``image_emb``, ``profile_emb``); ``ref_emb``: the
    reference's (image, profile) embeddings of the same pairs;
    ``ref_votes``: its votes (B, classes)."""
    emb_gap = vote_gap = votes_gap = mass_gap = 0.0
    rows = mismatched = 0
    for out, (ri, rp), votes in zip(served, ref_emb, ref_votes):
        for key, r in (("image_emb", ri), ("profile_emb", rp)):
            e = torch.as_tensor(out[key]).float().to(r.device)
            cos = torch.nn.functional.cosine_similarity(e, r, dim=1)
            if not torch.isfinite(cos).all():
                return dict.fromkeys(CLASSIFY_NUMBERS, math.inf)
            emb_gap = max(emb_gap, float((1 - cos).max()))
        cls = torch.as_tensor(out["class_id"]).long().to(votes.device)
        if cls.min() < 0 or cls.max() >= votes.shape[1]:
            return dict.fromkeys(CLASSIFY_NUMBERS, math.inf)
        if "votes" not in out:
            return dict.fromkeys(CLASSIFY_NUMBERS, math.inf)
        got_votes = torch.as_tensor(out["votes"]).float().to(votes.device)
        total = votes.sum(1)
        votes_gap = max(votes_gap, float(
            ((got_votes - votes).abs().sum(1) / total).max()))
        mass_gap = max(mass_gap, float(
            ((got_votes.sum(1) - total).abs() / total).max()))
        best, best_cls = votes.max(dim=1)
        got = votes.gather(1, cls[:, None])[:, 0]
        vote_gap = max(vote_gap, float(((best - got) / best).max()))
        mismatched += int((cls != best_cls).sum())
        rows += cls.shape[0]
    return {"emb_gap": emb_gap, "votes_gap": votes_gap,
            "vote_mass_gap": mass_gap, "vote_gap": vote_gap,
            "class_mismatch_pct": 100.0 * mismatched / max(rows, 1)}


def judge(numbers: Dict[str, float], limits: Dict[str, Dict]
          ) -> Optional[List[str]]:
    """The names of the compared numbers over their limits (or missing,
    or not finite); an empty list when every one holds."""
    bad = []
    for name, spec in limits.items():
        v = numbers.get(name)
        if v is None or not math.isfinite(v) or v > spec["limit"]:
            bad.append(name)
    return bad
