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
templates and static files must be byte copies. A test refuses any
import of the JAX package in the port's modules, in ``chip_smoke.py`` and
in the card's tests (``tests/test_torch_cuda.py``). The last tests hold
the port's test files to the rules that let the JAX package's CI run
without torch (each skips at import without it) and the card's machine
run the cuda-marked tests (all in one file, which needs no jax)."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "totton_tpu_torch"
#: The port's test files that read sources only: they import neither
#: torch nor the port, so they run (and guard the copies) without torch.
UNGUARDED = ("tests/test_torch_copies.py", "tests/test_torch_surface.py")
#: The statement every other test file of the port runs, at module level,
#: before anything that imports torch or the port: without torch (the JAX
#: package's CI installs none) the file is skipped, not an error.
TORCH_GUARD = 'torch = pytest.importorskip("torch")'
#: The one file that holds the port's cuda-marked tests; it runs on the
#: card with --noconftest (chip_smoke.py's phase ci).
CUDA_TESTS = "tests/test_torch_cuda.py"

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
        # A released slot drops its pre-swap bundle (ROADMAP C21).
        "StreamServer._release_detached_slots",
        "RowSplit.<fields>", "RowSplit.__init__", "RowSplit.__getitem__",
        "_row_split_step",
        # A server-wide block latency histogram beside the per-stream
        # reservoir, in STATS and the stats file as block_latency_ms.
        "LATENCY_EDGES_MS", "latency_quantile", "ServeStats.__init__",
        "ServeStats.add_block_latencies", "ServeStats._latency_json",
        "ServeStats.to_json",
        # The readers' serve.read and the writers' serve.write and
        # serve.send spans (StreamServer.spans).
        "StreamServer._reader", "StreamServer._writer",
        # The gather times the halo's host work (the tails array, each
        # served slot's tail copy, join and cut) for serve.gather_halo and
        # returns those intervals with the batch.
        "StreamServer._gather",
        # The start marks (Spans.mark, serve.setup.*): the constructor
        # marks the package's import up to this module's last line.
        "_IMPORT_END",
    },
    # The warm-up imports the port's fade widths. The threaded session's
    # loop reads the end-of-input flag before the input ring's fill (the
    # reference reads it after, and can pad its tail by a negative width
    # when the feeder finishes between the two reads; ROADMAP C19).
    "io/stream.py": {"_warm_up", "ThreadedStreamSession.run"},
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
    # Spans records the serve plane's host spans (StreamServer.spans),
    # and the server's start marks apart from the ring (clock, mark,
    # end_marks; in snapshot and write_chrome).
    "utils/profiling.py": {"trace_context", "check_kernel_records",
                           "NO_KERNEL_SUFFIX", "Spans.<fields>",
                           "Spans.__init__", "Spans.start", "Spans.stop",
                           "Spans._intern", "Spans.open", "Spans.close",
                           "Spans.add", "Spans.dropped", "Spans.snapshot",
                           "Spans.write_chrome", "Spans.clock", "Spans.mark",
                           "Spans.end_marks"},
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
    """Every .py of the port (relative to the repo), chip_smoke.py and the
    port's tests that run on the card's machine, which has no jax."""
    out = ["chip_smoke.py", CUDA_TESTS]
    for root, dirs, files in os.walk(os.path.join(REPO, PORT)):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        out += [os.path.relpath(os.path.join(root, f), REPO)
                for f in sorted(files) if f.endswith(".py")]
    return out


@pytest.mark.parametrize("rel", _port_sources())
def test_copy_is_not_an_import(rel):
    """No port module, not chip_smoke.py and not the card's tests import
    jax or the JAX package (``totton_tpu`` or ``totton_tpu.*``), at module
    top or inside a function."""
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


# ---- the port's test files ---------------------------------------------


def _port_tests() -> list[str]:
    return sorted(f"tests/{n}" for n in os.listdir(os.path.join(REPO, "tests"))
                  if n.startswith("test_torch_") and n.endswith(".py"))


def _imports_torch(node: ast.AST) -> bool:
    """Whether ``node`` imports torch, the port, chip_smoke or another of
    the port's test files, or imports a module by name (importlib)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Import):
            names = [a.name for a in n.names]
        elif isinstance(n, ast.ImportFrom):
            names = [n.module or ""]
        elif isinstance(n, ast.Call):
            f = n.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", "")
            if name in ("import_module", "__import__"):
                return True
            continue
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("torch", PORT, "chip_smoke") or top.startswith(
                    "test_torch_"):
                return True
    return False


def torch_guard_fault(source: str) -> str | None:
    """Why ``source`` (a test file of the port) would fail to import where
    torch is absent, or None: it needs TORCH_GUARD at module level, and no
    module-level statement before it may import torch or the port."""
    body = ast.parse(source).body
    guard = ast.dump(ast.parse(TORCH_GUARD).body[0])
    at = [i for i, node in enumerate(body) if ast.dump(node) == guard]
    if not at:
        return f"no module-level {TORCH_GUARD!r}"
    for node in body[:at[0]]:
        if _imports_torch(node):
            return f"line {node.lineno} imports before the guard"
    return None


def _source(rel: str) -> str:
    with open(os.path.join(REPO, rel)) as f:
        return f.read()


@pytest.mark.parametrize("rel", [r for r in _port_tests()
                                 if r not in UNGUARDED])
def test_port_test_file_skips_without_torch(rel):
    assert torch_guard_fault(_source(rel)) is None


@pytest.mark.parametrize("rel", [r for r in _port_tests()
                                 if r not in UNGUARDED])
def test_guard_check_fails_without_the_guard(rel):
    """The check above refuses each file with its guard taken out."""
    source = _source(rel).replace(TORCH_GUARD, "import torch")
    assert torch_guard_fault(source) is not None


@pytest.mark.parametrize("rel", UNGUARDED)
def test_unguarded_files_import_no_torch(rel):
    assert not _imports_torch(ast.parse(_source(rel)))


def _marks_cuda(node: ast.AST) -> bool:
    """Whether ``node`` contains ``pytest.mark.cuda``."""
    return any(isinstance(n, ast.Attribute) and n.attr == "cuda"
               and ast.unparse(n) == "pytest.mark.cuda"
               for n in ast.walk(node))


def test_cuda_marked_tests_live_in_one_file():
    """Every cuda-marked test of the repository is in CUDA_TESTS, which
    marks its whole module: no other test file has the mark, so the one
    command chip_smoke.py runs on the card takes every such test."""
    marked = []
    for name in sorted(os.listdir(os.path.join(REPO, "tests"))):
        if name.endswith(".py") and _marks_cuda(
                ast.parse(_source(f"tests/{name}"))):
            marked.append(f"tests/{name}")
    assert marked == [CUDA_TESTS]
    body = ast.parse(_source(CUDA_TESTS)).body
    assert "pytestmark = pytest.mark.cuda" in [ast.unparse(n) for n in body]
