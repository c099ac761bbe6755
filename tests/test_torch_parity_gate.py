"""The synthetic accuracy gate on the PyTorch port
(``scripts/parity_gate_torch.py``): the five pinned protocols of
``tests/test_parity_gate.py`` trained, encoded and scored by the port's
drivers on the CPU, each held in the JAX package's committed bands
(``tests/golden/parity_bands.json``, read and never written) and to the
reference's cross-modal pattern (P - P above I - P + 0.05).

Each protocol trains at the CLI's ``MODEL_SEEDS`` and is held by its one
rule, ``held``: the median of each accuracy over the draws. That is the
rule on the card too. ``vit_transformer_siglip`` (about 45 s on one
thread) runs in tier-1; the other four are ``slow``, as JAX's are. The
CLI's copy of the protocols equals JAX's.
"""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

import test_parity_gate as jax_gate
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
TIER1 = "vit_transformer_siglip"


def _cli():
    spec = importlib.util.spec_from_file_location(
        "parity_gate_torch", REPO / "scripts" / "parity_gate_torch.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["parity_gate_torch"] = module
    spec.loader.exec_module(module)
    return module


def test_protocols_are_jax_s():
    gate = _cli()
    assert gate.PROTOCOL_CARDS == jax_gate.PROTOCOL_CARDS
    assert gate.DATA_KW == jax_gate.DATA_KW
    assert (gate.GALLERY_N, gate.KNN_K, gate.REPEATS, gate.SETUPS) == (
        jax_gate.GALLERY_N, jax_gate.KNN_K, jax_gate.REPEATS,
        jax_gate.SETUPS)
    assert gate.GOLDEN == jax_gate.GOLDEN
    golden = json.loads(gate.GOLDEN.read_text())["protocols"]
    assert set(golden) == set(gate.PROTOCOL_CARDS)
    for protocol in gate.PROTOCOL_CARDS:
        assert gate.bands(protocol) == golden[protocol]["bands"]


def test_violations_and_no_calibration():
    gate = _cli()
    bands = gate.bands(TIER1)
    inside = {k: (lo + hi) / 2 for k, (lo, hi) in bands.items()}
    inside.update({"P - P": 0.5, "I+P - P": 0.5, "I - P": 0.2})
    assert gate.violations(TIER1, inside) == []
    low = dict(inside, **{"I - I": bands["I - I"][0] - 1e-3})
    assert [e.split(":")[0] for e in gate.violations(TIER1, low)] == \
        ["I - I"]
    flat = dict(inside, **{"I - P": 0.46})
    assert gate.violations(TIER1, flat)[-1].startswith(
        "cross-modal pattern")
    with pytest.raises(SystemExit) as e:  # the bands are JAX's record
        gate.main(["--calibrate"])
    assert e.value.code == 2


def test_median_of_draws_is_held():
    """The one rule: each key's median over the draws at ``MODEL_SEEDS``
    is held (one draw outside the band does not fail the protocol, two of
    three do); the pinned seed is among them, and the CLI has no other
    rule to choose."""
    gate = _cli()
    assert gate.MODEL_SEEDS == (0, 1, 2)
    assert jax_gate.PROTOCOL_CARDS[TIER1]["seed"] in gate.MODEL_SEEDS
    with pytest.raises(SystemExit) as e:
        gate.main(["--model-seeds", "0"])
    assert e.value.code == 2
    bands = gate.bands(TIER1)
    inside = {k: (lo + hi) / 2 for k, (lo, hi) in bands.items()}
    inside.update({"P - P": 0.5, "I+P - P": 0.5, "I - P": 0.2,
                   "first_train_loss": 8.0})
    high = dict(inside, **{"I - I": 0.6})
    median, errors = gate.held(TIER1, [inside, high, inside])
    assert errors == [] and median == inside
    assert gate.violations(TIER1, high) != []
    median, errors = gate.held(TIER1, [high, inside, high])
    assert median["I - I"] == 0.6 and errors[0].startswith("I - I")
    assert gate.held(TIER1, [high]) == (high, gate.violations(TIER1, high))


def test_model_seed_replaces_the_card_seed(tmp_path, monkeypatch):
    from multimodal_plankton_recognition_torch.train import drivers

    gate = _cli()
    seen = []

    def train_multi(split, card, **kwargs):
        seen.append(card.seed)
        raise StopIteration

    monkeypatch.setattr(drivers, "train_multi", train_multi)
    for model_seed, want in ((None, 0), (3, 3)):
        with pytest.raises(StopIteration):
            gate.run_parity_protocol(tmp_path / str(want), TIER1,
                                     device="cpu", model_seed=model_seed)
    assert seen == [0, 3]
    assert gate.PROTOCOL_CARDS[TIER1]["seed"] == 0


@pytest.mark.parametrize("protocol", [
    pytest.param(p, marks=() if p == TIER1 else pytest.mark.slow)
    for p in sorted(jax_gate.PROTOCOL_CARDS)])
def test_parity_bands(tmp_path, protocol):
    gate = _cli()
    golden = gate.GOLDEN.read_bytes()
    draws = [gate.run_parity_protocol(tmp_path / str(seed), protocol,
                                      device="cpu", model_seed=seed)
             for seed in gate.MODEL_SEEDS]
    median, errors = gate.held(protocol, draws)
    assert not errors, (f"parity gate violated for {protocol} on the port:"
                        f"\n  " + "\n  ".join(errors)
                        + f"\n  medians: {median}\n  draws: {draws}")
    for acc in draws:
        assert acc["final_train_loss"] < acc["first_train_loss"], acc
    assert gate.GOLDEN.read_bytes() == golden


def test_spread_script_holds_the_gate_s_rule(monkeypatch, capsys):
    """``scripts/parity_seeds.py`` (single draws at other model seeds)
    prints each draw with the keys outside the bands, then the gate's own
    rule over the draws at ``MODEL_SEEDS``."""
    spec = importlib.util.spec_from_file_location(
        "parity_seeds", REPO / "scripts" / "parity_seeds.py")
    seeds = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(seeds)
    gate = seeds.gate
    bands = gate.bands(TIER1)
    inside = {k: (lo + hi) / 2 for k, (lo, hi) in bands.items()}
    inside.update({"P - P": 0.5, "I+P - P": 0.5, "I - P": 0.2,
                   "first_train_loss": 8.0})
    draws = {0: inside, 1: dict(inside, **{"I - I": 0.6}), 2: inside,
             3: dict(inside, **{"I - I": 0.6})}
    monkeypatch.setattr(gate, "run_parity_protocol",
                        lambda workdir, protocol, device, model_seed:
                        draws[model_seed])
    assert seeds.main(["--package", "torch", "--protocols", TIER1,
                       "--model-seeds", "0", "1", "2", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(line)["outside"] for line in lines[:4]] == \
        [[], ["I - I"], [], ["I - I"]]
    assert lines[4].startswith(f"torch {TIER1}: medians at model seeds "
                               f"(0, 1, 2) ") and lines[4].endswith("held")
    assert lines[5] == "torch: 2 of 4 draws outside the bands"
