"""The port's arithmetic guards, pinned.

The exact decode equals the reference bit for bit only while no multiply
and add are contracted into one FMA, no denormal is flushed, and no f32
product runs at TF32.  These are set once (`kernels.NVCC_FLAGS`, the
package `__init__`) and would otherwise show only on the card.  No JAX.
"""

import ast
import pkgutil
from pathlib import Path

import torch

import carta1_tpu_torch
from carta1_tpu_torch import kernels


def test_nvcc_keeps_every_rounding():
    assert "-fmad=false" in kernels.NVCC_FLAGS
    for flag in ("--use_fast_math", "-use_fast_math", "-ftz=true", "--ftz=true", "-prec-div=false", "-prec-sqrt=false"):
        assert flag not in kernels.NVCC_FLAGS, flag


def test_tf32_is_off_after_import():
    assert carta1_tpu_torch.__name__ == "carta1_tpu_torch"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _compile_calls(tree: ast.AST) -> list[int]:
    """Lines that reach torch.compile: `torch.compile(...)`, `@torch.compile`,
    or `compile` imported from torch."""
    lines = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "compile" and (
                isinstance(node.value, ast.Name) and node.value.id == "torch"):
            lines.append(node.lineno)
        if isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] == "torch" and any(
                a.name == "compile" for a in node.names):
            lines.append(node.lineno)
    return lines


def test_no_module_calls_torch_compile():
    mods = list(pkgutil.walk_packages(carta1_tpu_torch.__path__, "carta1_tpu_torch."))
    files = [Path(carta1_tpu_torch.__file__)]
    for m in mods:
        spec = m.module_finder.find_spec(m.name.rsplit(".", 1)[-1])
        files.append(Path(spec.origin))
    assert len(files) >= 20
    found = {str(f): _compile_calls(ast.parse(f.read_text(), str(f))) for f in files}
    assert not {f: lines for f, lines in found.items() if lines}
    # the check itself finds a call
    assert _compile_calls(ast.parse("import torch\nf = torch.compile(g)\n")) == [2]
