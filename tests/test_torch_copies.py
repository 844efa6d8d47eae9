"""Drift guard for the port's copies of JAX-package modules.

``totton_tpu/serve.py``, ``io/stream.py``, ``engine/{selector,chain,
crossfeed}.py`` and ``eq/{apo,biquad}.py`` import the JAX engine (or sit in
a package that imports jax) at their top, so the port carries copies of
them. This test reads each pair as text (``ast.parse``, never an
import) and requires every top-level function and class member to be the
same code with docstrings stripped, except the device seams listed below.
A new divergence, or a seam that stopped diverging, fails."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Definitions of the copy that may differ from the reference (the device
# seams), and names only one side has (None on the side that lacks it).
SEAMS = {
    "serve.py": {
        "StreamServer.__init__", "StreamServer._fold", "StreamServer.set_eq",
        "StreamServer.load_filter", "StreamServer._apply_pending_control",
        "StreamServer._to_device", "StreamServer._drain_one",
        "StreamServer._dispatcher", "StreamServer.start",
        # The port's copies of the EQ modules (the JAX eq package loads
        # jax on import).
        "_profile_to_sos", "StreamServer._read_eq_block",
    },
    # The session without the JAX engine's sharding probes; the warm-up
    # imports the port's fade widths.
    "io/stream.py": {"StreamSession.__init__", "_warm_up"},
    "engine/selector.py": set(),
    "engine/chain.py": set(),
    "eq/apo.py": set(),
    "eq/biquad.py": set(),
    # The step and the processor's state on an explicit torch device.
    "engine/crossfeed.py": {
        "_make_cf_step", "CrossfeedProcessor.__init__",
        "CrossfeedProcessor.reset", "CrossfeedProcessor.process_block",
        "crossfeed_signal",
    },
}


def _strip_docstrings(node: ast.AST) -> ast.AST:
    for n in ast.walk(node):
        body = getattr(n, "body", None)
        if (isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            n.body = body[1:] or [ast.Pass()]
    return node


def _definitions(path: str) -> dict[str, str]:
    """name -> ast.dump (docstrings stripped) of every top-level function,
    every top-level assignment and every class member; a class's own
    non-function statements (fields) go under "<Class>.<fields>"."""
    with open(path) as f:
        tree = _strip_docstrings(ast.parse(f.read()))
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.ClassDef):
            fields = []
            for member in node.body:
                if isinstance(member, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{member.name}"] = ast.dump(member)
                else:
                    fields.append(ast.dump(member))
            out[f"{node.name}.<fields>"] = "\n".join(
                fields + [ast.dump(b) for b in node.bases]
                + [ast.dump(d) for d in node.decorator_list])
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name) and t.id != "log":
                    out[t.id] = ast.dump(node.value)
    return out


def _diverged(rel: str) -> set[str]:
    ref = _definitions(os.path.join(REPO, "totton_tpu", rel))
    port = _definitions(os.path.join(REPO, "totton_tpu_torch", rel))
    names = set(ref) | set(port)
    # A class the port does not carry counts as one seam, not per member.
    missing = {n.split(".")[0] for n in names
               if n.split(".")[0] not in {m.split(".")[0] for m in port}}
    return {n for n in names
            if n.split(".")[0] not in missing
            and ref.get(n) != port.get(n)} | missing


@pytest.mark.parametrize("rel", sorted(SEAMS))
def test_copy_matches_reference_outside_its_seams(rel):
    assert _diverged(rel) == SEAMS[rel]


@pytest.mark.parametrize("rel", sorted(SEAMS))
def test_copy_is_not_an_import(rel):
    """The copies must stay loadable without jax: none may import the JAX
    package's engine, ops, eq or serve modules."""
    with open(os.path.join(REPO, "totton_tpu_torch", rel)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            assert not node.module.startswith(
                ("totton_tpu.engine", "totton_tpu.ops", "totton_tpu.serve",
                 "totton_tpu.eq", "jax")), node.module
        if isinstance(node, ast.Import):
            assert not any(a.name.split(".")[0] == "jax"
                           for a in node.names)
