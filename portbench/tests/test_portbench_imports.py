"""Nothing under portbench imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's);
the reference and what it reads import nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench import run

BANNED = {"jax", "jaxlib", "flax", "totton_tpu"}
REFERENCE = ("reference.py", "audio.py", "wire.py", "compare.py")


def imported(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(run.PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(run.PKG)))
def test_no_jax(path):
    assert not imported(path) & BANNED


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_imports_nothing_of_the_port(name):
    assert "totton_tpu_torch" not in imported(run.PKG / name)


def test_a_run_loads_no_jax():
    code = ("import sys; import portbench.run as r, portbench.trace, "
            "portbench.loadgen; import totton_tpu_torch.serve; "
            "r.load_cell('serve80k.live'); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"{BANNED!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
    assert run.banned_modules() == []
