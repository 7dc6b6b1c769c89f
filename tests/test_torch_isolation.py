"""The port stands alone: no module under ``src/repro_torch/``, and not
``chip_smoke.py``, imports ``jax`` (or ``jaxlib``) or anything of the
JAX package ``repro``.  Only the tests import both."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    smoke = ROOT / "chip_smoke.py"
    if smoke.exists():
        files.append(smoke)
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_has_modules():
    assert len(_port_files()) > 20


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_repro_imports(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_training_modules_are_checked():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in _port_files()
             if "repro_torch" in p.parts}
    for module in ("optim/adamw.py", "data/pipeline.py", "checkpoint/manager.py",
                   "launch/train.py", "runtime/train_step.py", "runtime/monitor.py"):
        assert module in names


def test_paged_and_lowp_modules_are_checked():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in _port_files()
             if "repro_torch" in p.parts}
    for module in ("core/ops/paged.py", "kernels/attention_paged.py", "kernels/gemm_lowp.py"):
        assert module in names


def test_slice5_modules_are_checked():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in _port_files()
             if "repro_torch" in p.parts}
    for module in ("kernels/gemm_naive.py", "kernels/batched_gemm.py", "kernels/wkv6.py",
                   "kernels/ref.py", "kernels/ops.py", "models/rwkv.py", "configs/rwkv6_7b.py"):
        assert module in names
