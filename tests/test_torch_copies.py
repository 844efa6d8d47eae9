"""Drift guard for the port's copies of JAX-package modules.

The port imports nothing of the JAX package (``totton_tpu/__init__.py``
may import jax, and several of its modules import the JAX engine), so it
carries copies at the same relative paths: ``serve.py``, ``io/stream.py``,
``engine/{selector,chain,crossfeed}.py``, ``eq/{apo,biquad}.py`` and the
framework-free host modules (``io``, ``native``, ``filters``, ``utils``,
``control``, ``web``, ``testing``, ``integration`` and the ``control``,
``serve_client`` and ``webserver`` CLIs). This test reads each pair as
text (``ast.parse``, never an import) and requires every top-level
function and class member to be the same code with docstrings stripped
and the port's ``totton_tpu_torch`` imports read as ``totton_tpu``
(imports inside functions included), except the seams listed below. A
new divergence, or a seam that stopped diverging, fails. The web app's
templates and static files must be byte copies. A last test refuses any
import of the JAX package in the port's modules and in
``chip_smoke.py``."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "totton_tpu_torch"

# Definitions of the copy that may differ from the reference (the device
# seams), and names only one side has (None on the side that lacks it).
SEAMS = {
    # The mesh path splits a step's rows over the mesh's devices
    # (RowSplit, _row_split_step) where the JAX package shards one array.
    "serve.py": {
        "StreamServer.__init__", "StreamServer._fold", "StreamServer.set_eq",
        "StreamServer.load_filter", "StreamServer._apply_pending_control",
        "StreamServer._to_device", "StreamServer._drain_one",
        "StreamServer._dispatcher", "StreamServer.start",
        "RowSplit.<fields>", "RowSplit.__init__", "RowSplit.__getitem__",
        "_row_split_step",
    },
    # The warm-up imports the port's fade widths.
    "io/stream.py": {"_warm_up"},
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
    # Framework-free host modules, copied so that the port never imports
    # the JAX package (whose __init__ may load jax).
    "io/pcm.py": set(),
    "io/devices.py": set(),
    "io/formats.py": set(),
    "io/wav.py": set(),
    "io/ring_buffer.py": set(),
    "io/sockets.py": set(),
    # The client refuses a rate <= 0 before connecting, and an announced
    # output rate that is not a positive multiple of its rate.
    "io/serve_client.py": {"ServeClient.__init__"},
    # The library is built into the port's build root, never next to its
    # source, and renamed into place once complete.
    "native/__init__.py": {"_LIB_PATH", "_build"},
    "filters/sidecar.py": set(),
    "filters/hrtf.py": set(),
    "utils/intmath.py": set(),
    # trace_context wraps torch.profiler where the reference wraps
    # jax.profiler, and marks a CUDA window that kept launches but no
    # kernel record (check_kernel_records, NO_KERNEL_SUFFIX).
    "utils/profiling.py": {"trace_context", "check_kernel_records",
                           "NO_KERNEL_SUFFIX"},
    "control/wiring.py": set(),
    "control/daemon.py": set(),
    "control/server.py": set(),
    "control/client.py": set(),
    "control/follower.py": set(),
    "web/constants.py": set(),
    "web/services/config.py": set(),
    "testing/signals.py": set(),
    "testing/validate_output.py": set(),
    "testing/convert_audio.py": set(),
    "io/negotiation.py": set(),
    # The exit path shuts the socket down before it joins the pump, and
    # joins with a bounded wait: a pump blocked in sendall against a
    # server that stopped reading no longer holds the error exit for up
    # to --timeout.
    "cli/serve_client.py": {"main"},
    "cli/control.py": set(),
    "cli/webserver.py": set(),
    "filters/design.py": set(),
    "filters/validate.py": set(),
    "filters/generate.py": set(),
    "filters/plots.py": set(),
    "integration/__init__.py": set(),
    "integration/modern_target.py": set(),
    "integration/opra.py": set(),
    "integration/opra_cache.py": set(),
    "integration/opra_downloader.py": set(),
    "integration/opra_sync.py": set(),
    "web/app.py": set(),
    "web/i18n.py": set(),
    "web/services/daemon.py": set(),
    "web/services/eq.py": set(),
    "web/services/restart.py": set(),
}

#: Files the port carries byte for byte: the web app's templates and
#: static assets, which ``web/app.py`` loads from next to itself.
BYTE_COPIES = [
    f"web/templates/{n}" for n in ("components.html", "index.html",
                                   "layout.html", "opra_sync.html",
                                   "settings.html")
] + ["web/static/app.js", "web/static/app.css"]


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


def _unrename(node: ast.AST) -> ast.AST:
    """Read every ``totton_tpu_torch...`` import as its ``totton_tpu...``
    counterpart: a copy that imports the port's copy of a module, where
    the reference imports its own, does not diverge."""
    for n in ast.walk(node):
        if isinstance(n, ast.ImportFrom) and n.module:
            n.module = _reference_name(n.module)
        elif isinstance(n, ast.Import):
            for a in n.names:
                a.name = _reference_name(a.name)
    return node


def _reference_name(module: str) -> str:
    if module == PORT or module.startswith(PORT + "."):
        return "totton_tpu" + module[len(PORT):]
    return module


def _definitions(path: str) -> dict[str, str]:
    """name -> ast.dump (docstrings stripped, the port's imports read as
    the reference's) of every top-level function, every top-level
    assignment and every class member; a class's own non-function
    statements (fields) go under "<Class>.<fields>"."""
    with open(path) as f:
        tree = _unrename(_strip_docstrings(ast.parse(f.read())))
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


@pytest.mark.parametrize("rel", BYTE_COPIES)
def test_byte_copy_matches_reference(rel):
    with open(os.path.join(REPO, "totton_tpu", rel), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, PORT, rel), "rb") as f:
        assert f.read() == ref


def test_byte_copies_cover_the_reference_assets():
    """Every template and static file of the reference's web app is in
    BYTE_COPIES."""
    ref = []
    for sub in ("templates", "static"):
        d = os.path.join(REPO, "totton_tpu", "web", sub)
        ref += [f"web/{sub}/{n}" for n in os.listdir(d)]
    assert sorted(ref) == sorted(BYTE_COPIES)


def _port_sources() -> list[str]:
    """Every .py of the port (relative to the repo) and chip_smoke.py."""
    out = ["chip_smoke.py"]
    for root, dirs, files in os.walk(os.path.join(REPO, PORT)):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        out += [os.path.relpath(os.path.join(root, f), REPO)
                for f in sorted(files) if f.endswith(".py")]
    return out


@pytest.mark.parametrize("rel", _port_sources())
def test_copy_is_not_an_import(rel):
    """No port module, and not chip_smoke.py, imports jax or the JAX
    package (``totton_tpu`` or ``totton_tpu.*``), at module top or inside
    a function."""
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
        elif isinstance(node, ast.Import):
            names += [a.name for a in node.names]
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "totton_tpu"), f"{rel} imports {name}"


def test_the_parallel_modules_are_checked():
    """The sharded engine's modules (no reference copy: their own code)
    are among the sources the import check walks."""
    sources = set(_port_sources())
    for name in ("__init__", "mesh", "distributed", "sharded", "dryrun"):
        assert f"{PORT}/parallel/{name}.py" in sources
