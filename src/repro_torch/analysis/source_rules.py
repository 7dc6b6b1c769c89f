"""Source-level precision rules: the sweep over the port's Python and CUDA
sources (twin of ``repro.analysis.source_rules``).

The graph rules see only code reachable from a registered audit surface.
A raw contraction in a model file runs at whatever dtype its operands
carry: once a policy casts activations to bf16, ``torch.einsum`` on them
multiplies and accumulates in bf16 (the paper's worst-precision quadrant)
where ``repro`` pins ``preferred_element_type=jnp.float32``.  So two
sweeps judge the sources directly:

  SRC001  every ``torch.einsum`` / ``matmul`` / ``mm`` / ``bmm`` /
          ``tensordot`` call and every ``@`` in ``src/repro_torch/**/*.py``
          either upcasts each operand at the call (``.float()``,
          ``.double()``, ``.to(torch.float32)``; ``.astype(np.float64)``
          for numpy operands) or passes ``out_dtype=torch.float32``: the
          syntactic twin of ``preferred_element_type``.  ``.float()`` on an
          f32 tensor returns the tensor itself, so stating it costs nothing.
  PAL003  every tensor-core form in ``src/repro_torch/csrc/*.cu*`` has a
          32-bit accumulator: each ``wgmma.mma_async`` and
          ``mma.sync.aligned`` form an ``.f32`` (or ``.s32``) D type, each
          ``wmma::fragment<wmma::accumulator, ...>`` a ``float`` (or
          ``int``) element.  The sources that reach ``wgmma`` through a
          helper (``gemm_refined_sm90.cuh``, ``flash_bwd_sm90.cuh`` call
          ``gemm_sm90.cuh``'s and ``flash_sm90.cuh``'s) are covered by the
          helper's own form; a form whose D type the sweep cannot read is
          a finding too.
"""

from __future__ import annotations

import ast
import os
import re

from repro_torch.analysis.rules import Finding, make_finding

__all__ = ["scan_source", "scan_cuda_source", "default_source_root", "default_cuda_root"]

_CONTRACTIONS = ("einsum", "matmul", "mm", "bmm", "tensordot")
_WIDE = ("float32", "float64", "float", "double")


def default_source_root() -> str:
    """``src/repro_torch`` relative to this package (the audited tree)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_cuda_root() -> str:
    return os.path.join(default_source_root(), "csrc")


def _wide_dtype(node: ast.AST) -> bool:
    """``torch.float32`` / ``np.float64`` / ``"float32"`` and the like."""
    if isinstance(node, ast.Attribute):
        return node.attr in _WIDE
    return isinstance(node, ast.Constant) and node.value in _WIDE


def _upcast(node: ast.AST) -> bool:
    """An operand widened at the call: ``x.float()``, ``x.double()``,
    ``x.to(<f32/f64>)`` or ``x.astype(<f32/f64>)``."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return False
    attr = node.func.attr
    if attr in ("float", "double"):
        return not node.args
    if attr in ("to", "astype"):
        dtypes = list(node.args[:1]) + [kw.value for kw in node.keywords if kw.arg == "dtype"]
        return any(_wide_dtype(d) for d in dtypes)
    return False


def _torch_contraction(node: ast.Call) -> str | None:
    fn = node.func
    if (isinstance(fn, ast.Attribute) and fn.attr in _CONTRACTIONS
            and isinstance(fn.value, ast.Name) and fn.value.id == "torch"):
        return fn.attr
    return None


def _operands(name: str, node: ast.Call) -> list[ast.AST]:
    return list(node.args[1:] if name == "einsum" else node.args[:2])


def _scan_file(path: str, rel: str) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [make_finding("SRC001", f"{rel}:{e.lineno or 0}",
                             f"unparseable source: {e.msg}")]
    out: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            if not (_upcast(node.left) and _upcast(node.right)):
                out.append(make_finding(
                    "SRC001", f"{rel}:{node.lineno}",
                    "'@' without f32 operands at the call: multiplies and "
                    "accumulates in the operand dtype once a policy narrows "
                    "the inputs"))
            continue
        if not isinstance(node, ast.Call):
            continue
        name = _torch_contraction(node)
        if name is None:
            continue
        kwargs = {kw.arg: kw.value for kw in node.keywords}
        if None in kwargs or _wide_dtype(kwargs.get("out_dtype")):
            continue            # explicit accumulator (or **kwargs pass-through)
        ops = _operands(name, node)
        if ops and all(_upcast(x) for x in ops):
            continue
        out.append(make_finding(
            "SRC001", f"{rel}:{node.lineno}",
            f"torch.{name} without f32 operands or out_dtype=torch.float32 — "
            f"accumulates in the operand dtype once a policy narrows the "
            f"inputs"))
    return out


def _walk(root: str, suffixes: tuple[str, ...]):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if fname.endswith(suffixes):
                path = os.path.join(dirpath, fname)
                yield path, os.path.relpath(path, root)


def scan_source(root: str | None = None) -> list[Finding]:
    """SRC001 findings over every ``.py`` under ``root`` (default: the
    ``src/repro_torch`` tree)."""
    root = root or default_source_root()
    findings: list[Finding] = []
    for path, rel in _walk(root, (".py",)):
        findings.extend(_scan_file(path, rel))
    return findings


# wgmma.mma_async[.sp].sync.aligned.mXnYkZ.<D>.<A>.<B>
_WGMMA = re.compile(r"wgmma\.mma_async(?:\.sp)?\.sync\.aligned\.m\d+n\d+k\d+\.(\w+)")
# mma[.sp].sync.aligned.mXnYkZ[.row|.col ...].<D>.<A>.<B>.<C>
_MMA = re.compile(r"(?<![\w.])mma(?:\.sp)?\.sync\.aligned\.m\d+n\d+k\d+((?:\.(?:row|col))*)\.(\w+)")
_WMMA = re.compile(r"wmma::fragment\s*<\s*(?:nvcuda::)?wmma::accumulator\s*,([^>]*)>")
_WIDE_D = ("f32", "s32", "f64")
_WIDE_FRAG = ("float", "int", "double")


def _scan_cuda_file(path: str, rel: str) -> list[Finding]:
    out: list[Finding] = []
    with open(path, encoding="utf-8") as f:
        lines = f.read().split("\n")
    for lineno, line in enumerate(lines, 1):
        # a form in a comment is prose, not code (the asm strings hold no //)
        code = line if '"' in line else line.split("//", 1)[0]
        forms = []
        if "wgmma.mma_async" in code:
            m = _WGMMA.search(code)
            forms.append(("wgmma", m.group(1) if m else None, _WIDE_D))
        if "mma.sync.aligned" in code and "wgmma" not in code:
            m = _MMA.search(code)
            forms.append(("mma.sync", m.group(2) if m else None, _WIDE_D))
        if "wmma::accumulator" in code and "fragment" in code:
            m = _WMMA.search(code)
            elem = m.group(1).split(",")[-1].strip() if m else None
            forms.append(("wmma accumulator fragment", elem, _WIDE_FRAG))
        for what, dtype, wide in forms:
            if dtype in wide:
                continue
            out.append(make_finding(
                "PAL003", f"{rel}:{lineno}",
                f"{what} accumulates in {dtype or 'an unreadable type'} — a "
                f"tensor-core accumulator must be f32 (the paper's "
                f"accumulate-in-full-precision invariant)"))
    return out


def scan_cuda_source(root: str | None = None) -> list[Finding]:
    """PAL003 findings over every ``.cu`` / ``.cuh`` under ``root``
    (default: ``src/repro_torch/csrc``)."""
    root = root or default_cuda_root()
    findings: list[Finding] = []
    for path, rel in _walk(root, (".cu", ".cuh")):
        findings.extend(_scan_cuda_file(path, rel))
    return findings
