"""The port imports torch and numpy, never JAX, flax, optax, orbax or the
JAX package — checked by parsing its sources, since this interpreter may
already have jax loaded."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "semantic_segmentation_tpu")


def _sources():
    """The package, and every file that runs on the machine with the card,
    where JAX is not installed."""
    files = sorted((ROOT / "semantic_segmentation_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "scripts" / "profile_torch_end2end.py",
                    ROOT / "scripts" / "ab_torch_trainer.py",
                    ROOT / "scripts" / "drift_torch_chaos_control.py",
                    ROOT / "scripts" / "validate_torch_learning.py",
                    ROOT / "scripts" / "nas_torch_flagship.py",
                    ROOT / "scripts" / "nas_torch_win.py",
                    ROOT / "tests" / "test_torch_cuda_kernels.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.exists()
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
