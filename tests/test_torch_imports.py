"""Import hygiene of the port and the no-fallback contract of
``chip_smoke.py``.

The port never imports JAX, nor anything of the JAX package
(``multimodal_plankton_recognition_tpu``), not even lazily inside a
function; its card paths (everything ``chip_smoke.py`` drives: the encode
path, the train path and the model-card path ``config.ModelCard.from_dict``
→ ``models.build`` → ``train.Fitter``) load none of jax, flax, pandas, PIL
or yaml, which the card's machine need not have. ``config.load_card``
imports yaml, and the port's own host layers (``data.dataset``,
``data.transforms``, ``data.profile_io``, behind ``encode_csv``) pandas
and PIL, only when called.
"""

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "multimodal_plankton_recognition_torch"
CARD_PATH_MODULES = [
    "multimodal_plankton_recognition_torch",
    "multimodal_plankton_recognition_torch.convert",
    "multimodal_plankton_recognition_torch.data.dataset",
    "multimodal_plankton_recognition_torch.data.pipeline",
    "multimodal_plankton_recognition_torch.data.profile_io",
    "multimodal_plankton_recognition_torch.data.tokenize",
    "multimodal_plankton_recognition_torch.data.transforms",
    "multimodal_plankton_recognition_torch.models.attention",
    "multimodal_plankton_recognition_torch.models.batchnorm",
    "multimodal_plankton_recognition_torch.models.ffn",
    "multimodal_plankton_recognition_torch.models.flagships",
    "multimodal_plankton_recognition_torch.models.image.efficientnet",
    "multimodal_plankton_recognition_torch.models.image.encoder",
    "multimodal_plankton_recognition_torch.models.image.registry",
    "multimodal_plankton_recognition_torch.models.image.vit",
    "multimodal_plankton_recognition_torch.models.multi",
    "multimodal_plankton_recognition_torch.models.profile.cnn",
    "multimodal_plankton_recognition_torch.models.profile.factory",
    "multimodal_plankton_recognition_torch.models.profile.transformer",
    "multimodal_plankton_recognition_torch.ops.attention",
    "multimodal_plankton_recognition_torch.ops.build",
    "multimodal_plankton_recognition_torch.ops.ffn",
    "multimodal_plankton_recognition_torch.ops.knn",
    "multimodal_plankton_recognition_torch.ops.losses",
    "multimodal_plankton_recognition_torch.retrieval.encode",
]
TRAIN_PATH_MODULES = [
    "multimodal_plankton_recognition_torch.config",
    "multimodal_plankton_recognition_torch.models.build",
    "multimodal_plankton_recognition_torch.models.dropout",
    "multimodal_plankton_recognition_torch.ops.contrastive",
    "multimodal_plankton_recognition_torch.ops.mbconv",
    "multimodal_plankton_recognition_torch.train",
    "multimodal_plankton_recognition_torch.train.early_stopping",
    "multimodal_plankton_recognition_torch.train.logging",
    "multimodal_plankton_recognition_torch.train.loop",
    "multimodal_plankton_recognition_torch.train.optim",
    "multimodal_plankton_recognition_torch.train.state",
]
FORBIDDEN = ("jax", "flax", "pandas", "PIL", "yaml")


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
