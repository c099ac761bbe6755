"""Each cell run once on the card for a short window, as the command
runs it: exit 0, ``correct`` true, the cell's metrics, the device named.
Marked ``gpu``: skips without a CUDA card (decided in the fixture).

    python -m pytest -m gpu portbench/tests/test_portbench_card.py -q
"""

import json
import subprocess
import sys

import pytest
import torch

from portbench.harness.manifest import ROOT, load_manifest, resolve

pytestmark = pytest.mark.gpu
MANIFEST = load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cuda, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 33 + 101), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    c = resolve(cell, MANIFEST)
    want = c.per_layer if trace else c.end_to_end
    assert set(result["metrics"]) == {m["name"] for m in want}
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]
