"""Import hygiene of the port and the no-fallback contract of
``chip_smoke.py``.

The port never imports JAX, nor anything of the JAX package
(``multimodal_plankton_recognition_tpu``), not even lazily inside a
function; its card paths (everything ``chip_smoke.py`` drives: the encode
path, the train path and the model-card path ``config.ModelCard.from_dict``
→ ``models.build`` → ``train.Fitter``) load none of jax, flax, pandas, PIL
or yaml, which the card's machine need not have. ``config.load_card``
imports yaml, and the port's own host layers (``data.dataset``,
``data.transforms``, ``data.profile_io``, behind ``encode_csv``, and
``data.packed.pack_split``, ``data.synthetic``) pandas and PIL, only
when called; ``train.metrics`` and ``retrieval.results`` matplotlib and
PIL, only when a figure is drawn. The port's CLIs
(``scripts/encode_torch.py``, ``scripts/train_{multi,image,profile}_torch.py``,
``scripts/benchmark_{raw,folds,cross,cross_folds}_torch.py``,
``scripts/results_torch.py``, ``scripts/export_model_torch.py``,
``scripts/serve_torch.py``, ``scripts/analysis_torch.py``, and the
converter, pack and parity CLIs ``scripts/convert_timm_torch.py``,
``scripts/pack_dataset_torch.py``, ``scripts/parity_real_torch.py``,
``scripts/parity_gate_torch.py``) import no JAX
either, and load none of the forbidden modules at import; the serving
path (``retrieval.export``, ``ops.knn`` and the kernels' op
registrations) loads none of them, nor the model code; the bridge from orbax
(``scripts/checkpoint_from_jax.py``) does import JAX, and so lives
outside the package. ``chip_smoke.py``'s ``classify``, ``retrieval``,
``backbones``, ``remat``, ``export``, ``tail`` and ``pretrained`` phases
import only modules that load none of them.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "multimodal_plankton_recognition_torch"
CARD_PATH_MODULES = [
    "multimodal_plankton_recognition_torch",
    "multimodal_plankton_recognition_torch.convert",
    "multimodal_plankton_recognition_torch.data.dataset",
    "multimodal_plankton_recognition_torch.data.grain_pipeline",
    "multimodal_plankton_recognition_torch.data.packed",
    "multimodal_plankton_recognition_torch.data.pipeline",
    "multimodal_plankton_recognition_torch.data.profile_io",
    "multimodal_plankton_recognition_torch.data.synthetic",
    "multimodal_plankton_recognition_torch.data.tokenize",
    "multimodal_plankton_recognition_torch.data.transforms",
    "multimodal_plankton_recognition_torch.models.attention",
    "multimodal_plankton_recognition_torch.models.batchnorm",
    "multimodal_plankton_recognition_torch.models.convert_timm",
    "multimodal_plankton_recognition_torch.models.dense",
    "multimodal_plankton_recognition_torch.models.ffn",
    "multimodal_plankton_recognition_torch.models.flagships",
    "multimodal_plankton_recognition_torch.models.image.densenet",
    "multimodal_plankton_recognition_torch.models.image.efficientnet",
    "multimodal_plankton_recognition_torch.models.image.encoder",
    "multimodal_plankton_recognition_torch.models.image.registry",
    "multimodal_plankton_recognition_torch.models.image.resnet",
    "multimodal_plankton_recognition_torch.models.image.vit",
    "multimodal_plankton_recognition_torch.models.initializers",
    "multimodal_plankton_recognition_torch.models.multi",
    "multimodal_plankton_recognition_torch.models.pretrained",
    "multimodal_plankton_recognition_torch.models.profile.cnn",
    "multimodal_plankton_recognition_torch.models.profile.factory",
    "multimodal_plankton_recognition_torch.models.profile.lstm",
    "multimodal_plankton_recognition_torch.models.profile.transformer",
    "multimodal_plankton_recognition_torch.ops.attention",
    "multimodal_plankton_recognition_torch.ops.augment",
    "multimodal_plankton_recognition_torch.ops.build",
    "multimodal_plankton_recognition_torch.ops.ffn",
    "multimodal_plankton_recognition_torch.ops.knn",
    "multimodal_plankton_recognition_torch.ops.losses",
    "multimodal_plankton_recognition_torch.ops.pacmap",
    "multimodal_plankton_recognition_torch.ops.quant",
    "multimodal_plankton_recognition_torch.parallel",
    "multimodal_plankton_recognition_torch.parallel.contrastive",
    "multimodal_plankton_recognition_torch.parallel.knn",
    "multimodal_plankton_recognition_torch.parallel.mesh",
    "multimodal_plankton_recognition_torch.parallel.multihost",
    "multimodal_plankton_recognition_torch.retrieval.benchmark",
    "multimodal_plankton_recognition_torch.retrieval.encode",
    "multimodal_plankton_recognition_torch.retrieval.export",
    "multimodal_plankton_recognition_torch.retrieval.results",
    "multimodal_plankton_recognition_torch.train.checkpoint",
    "multimodal_plankton_recognition_torch.utils",
    "multimodal_plankton_recognition_torch.utils.labels",
]
TRAIN_PATH_MODULES = [
    "multimodal_plankton_recognition_torch.config",
    "multimodal_plankton_recognition_torch.models.build",
    "multimodal_plankton_recognition_torch.models.classifier",
    "multimodal_plankton_recognition_torch.models.dropout",
    "multimodal_plankton_recognition_torch.ops.contrastive",
    "multimodal_plankton_recognition_torch.ops.mbconv",
    "multimodal_plankton_recognition_torch.ops.augment",
    "multimodal_plankton_recognition_torch.train",
    "multimodal_plankton_recognition_torch.train.checkpoint",
    "multimodal_plankton_recognition_torch.train.drivers",
    "multimodal_plankton_recognition_torch.train.early_stopping",
    "multimodal_plankton_recognition_torch.train.logging",
    "multimodal_plankton_recognition_torch.train.loop",
    "multimodal_plankton_recognition_torch.train.metrics",
    "multimodal_plankton_recognition_torch.train.optim",
    "multimodal_plankton_recognition_torch.train.shard_step",
    "multimodal_plankton_recognition_torch.train.state",
]
FORBIDDEN = ("jax", "flax", "pandas", "PIL", "yaml", "matplotlib")
SMOKE_PHASES = ("phase_classify", "phase_retrieval", "phase_backbones",
                "phase_remat", "phase_export", "phase_tail",
                "phase_pretrained")


def _forbidden_after_importing(modules):
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"print(sorted(m for m in {FORBIDDEN!r} if m in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_card_path_imports_nothing_forbidden():
    assert _forbidden_after_importing(CARD_PATH_MODULES) == "[]"


def test_train_path_imports_nothing_forbidden():
    assert _forbidden_after_importing(TRAIN_PATH_MODULES) == "[]"


#: what loading a serving artifact imports: the export module, the kNN
#: and the op registrations of the kernels a program may keep
SERVING_PATH_MODULES = [
    "multimodal_plankton_recognition_torch.retrieval.export",
    "multimodal_plankton_recognition_torch.ops.knn",
    "multimodal_plankton_recognition_torch.ops.attention",
    "multimodal_plankton_recognition_torch.ops.attention_block",
    "multimodal_plankton_recognition_torch.ops.ffn",
]


def test_serving_path_imports_nothing_forbidden_nor_the_models():
    """The serving path loads none of the forbidden modules, and loading
    an artifact registers the kernels' ops without the model code."""
    code = (
        "import importlib, sys\n"
        f"for m in {SERVING_PATH_MODULES!r}: importlib.import_module(m)\n"
        "from multimodal_plankton_recognition_torch.retrieval import "
        "export\n"
        "export._register_ops()\n"
        "import torch\n"
        "ops = [torch.ops.plankton.mha_qkv_fwd, torch.ops.plankton.mha_fwd,"
        " torch.ops.plankton.ffn_fwd, torch.ops.plankton.attn_block_fwd]\n"
        "print(sorted(m for m in sys.modules if m in "
        f"{FORBIDDEN!r} or '.models' in m))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax():
    """Also the lazy imports inside functions: no module of the port, and
    nothing in chip_smoke.py, imports JAX or the JAX package."""
    forbidden = {"jax", "jaxlib", "flax", "optax", "orbax",
                 "multimodal_plankton_recognition_tpu"}
    for path in [*PACKAGE.rglob("*.py"), REPO / "chip_smoke.py"]:
        assert not set(_imported_roots(path)) & forbidden, path


def _cli_loads(name):
    """The forbidden modules that running ``scripts/<name>.py --help``
    loads; the script must name no JAX module."""
    script = REPO / "scripts" / f"{name}.py"
    assert not set(_imported_roots(script)) & {
        "jax", "jaxlib", "flax", "optax", "orbax",
        "multimodal_plankton_recognition_tpu"}
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{str(script)!r}, '--help']\n"
        "try:\n"
        f"    runpy.run_path({str(script)!r}, run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        f"print(sorted(m for m in {FORBIDDEN!r} if m in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def test_encode_cli_imports_no_jax():
    """``scripts/encode_torch.py`` names no JAX module, and running it
    (``--help``) loads none of the forbidden modules."""
    assert _cli_loads("encode_torch") == "[]"


def test_train_cli_imports_no_jax():
    """``scripts/train_multi_torch.py`` the same: a JSON card trains with
    no yaml."""
    assert _cli_loads("train_multi_torch") == "[]"


NEW_CLIS = ("train_image_torch", "train_profile_torch",
            "benchmark_raw_torch", "benchmark_folds_torch",
            "benchmark_cross_torch", "benchmark_cross_folds_torch",
            "results_torch", "export_model_torch", "serve_torch",
            "analysis_torch", "convert_timm_torch", "pack_dataset_torch",
            "parity_real_torch", "parity_gate_torch")


@pytest.fixture(scope="module")
def new_cli_loads():
    """{CLI: the forbidden modules that running it (``--help``) loaded},
    the CLIs of ``NEW_CLIS`` run one after another in one process (one
    torch import for all of them)."""
    scripts = {name: str(REPO / "scripts" / f"{name}.py")
               for name in NEW_CLIS}
    code = (
        "import json, runpy, sys\n"
        "out = {}\n"
        f"for name, script in {scripts!r}.items():\n"
        f"    before = {{m for m in {FORBIDDEN!r} if m in sys.modules}}\n"
        "    sys.argv = [script, '--help']\n"
        "    try:\n"
        "        runpy.run_path(script, run_name='__main__')\n"
        "    except SystemExit:\n"
        "        pass\n"
        f"    out[name] = sorted({{m for m in {FORBIDDEN!r} "
        "if m in sys.modules} - before)\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", NEW_CLIS)
def test_classifier_and_benchmark_clis_import_no_jax(name, new_cli_loads):
    """The supervised train CLIs, the benchmark CLIs, the results CLI and
    the serving and analysis CLIs: no JAX module named, none of the
    forbidden modules loaded."""
    script = REPO / "scripts" / f"{name}.py"
    assert not set(_imported_roots(script)) & {
        "jax", "jaxlib", "flax", "optax", "orbax",
        "multimodal_plankton_recognition_tpu"}
    assert new_cli_loads[name] == []


def _smoke_functions():
    """chip_smoke.py's top-level functions by name."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    return {node.name: node for node in tree.body
            if isinstance(node, ast.FunctionDef)}


def _reached(functions, roots):
    """The names of ``roots`` and of every chip_smoke.py function they
    call, transitively."""
    seen, todo = set(), list(roots)
    while todo:
        name = todo.pop()
        if name in seen or name not in functions:
            continue
        seen.add(name)
        todo.extend(n.id for n in ast.walk(functions[name])
                    if isinstance(n, ast.Name) and n.id in functions)
    return seen


def test_smoke_classify_and_retrieval_phases_reach_nothing_forbidden():
    """Every module that the new phases of chip_smoke.py (and the
    functions of chip_smoke.py they call) import is one of the port's,
    and importing them all loads none of the forbidden modules."""
    functions = _smoke_functions()
    reached = _reached(functions, SMOKE_PHASES)
    assert set(SMOKE_PHASES) <= reached
    modules = set()
    for name in reached:
        for node in ast.walk(functions[name]):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                modules.add(node.module)
            elif isinstance(node, ast.Import):
                modules.update(a.name for a in node.names)
    ours = {m for m in modules if m.startswith(PACKAGE.name)}
    assert {f"{PACKAGE.name}.retrieval.benchmark",
            f"{PACKAGE.name}.models.build"} <= ours
    assert not {m.split(".")[0] for m in modules} & set(FORBIDDEN)
    assert _forbidden_after_importing(sorted(ours)) == "[]"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CPU fallback: without CUDA, and alone in a directory without the
    repository, the smoke run exits non-zero and prints no result."""
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
