"""The port's surface against the JAX package's, read by AST (never by
import, so neither package loads here).

(a) Every public top-level name of every module under ``totton_tpu/``
exists in the module at the same relative path under
``totton_tpu_torch/``, every public method of every public class exists
in the port's class, and every parameter of a public function or method
exists in the port's, except the TPU-only names of ``TPU_ONLY``. A
package ``__init__``'s public names are its imports and ``__all__``; the
port's may also name them in a ``_LAZY`` table (imported on first
attribute access by a module ``__getattr__``).

(b) Every ``.py`` module under ``totton_tpu/`` has its counterpart file
under ``totton_tpu_torch/``; ``COUNTERPARTS`` holds the two exceptions.

(c) Every test file of the JAX package, ``tests/test_<name>.py``, has its
twin ``tests/test_torch_<name>.py``, or sits in ``NO_TWIN`` with the
port's tests that hold what it tests and the reason.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "totton_tpu")
PORT = os.path.join(REPO, "totton_tpu_torch")

#: Reference modules whose counterpart sits elsewhere in the port.
COUNTERPARTS = {
    # The Pallas frame kernel: a CUDA kernel and its wrapper.
    "experimental/pallas_kernels.py": ["ops/fused_frames.py",
                                       "csrc/fused_frames.cu"],
    # Only re-exports the Pallas module; nothing of it is a port surface.
    "experimental/__init__.py": [],
}

#: The JAX package's test files with no ``test_torch_<name>.py`` twin:
#: each maps to (the port's test files that hold what it tests, why).
NO_TWIN = {
    "test_control.py": (
        ("test_torch_copies.py", "test_torch_live_control.py",
         "test_torch_control_cli.py"),
        "control/{daemon,server,client}.py are verbatim copies; the port's "
        "control plane is driven in its live-control and control-CLI tests"),
    "test_eq.py": (
        ("test_torch_copies.py", "test_torch_iir.py"),
        "eq/{apo,biquad}.py are verbatim copies; the time-domain cascade, "
        "the port's own kernel, is held to the JAX scan in test_torch_iir"),
    "test_hrtf_plots.py": (
        ("test_torch_copies.py",),
        "filters/{hrtf,plots}.py are verbatim copies and run no device "
        "code"),
    "test_hrtf_sofa.py": (
        ("test_torch_copies.py", "test_torch_crossfeed.py"),
        "filters/hrtf.py is a verbatim copy; the crossfeed processor it "
        "feeds is held to the JAX package's in test_torch_crossfeed"),
    "test_io.py": (
        ("test_torch_copies.py", "test_torch_negotiation.py"),
        "io/{pcm,wav,devices,formats,ring_buffer,negotiation}.py are "
        "verbatim copies; negotiation has its parity test"),
    "test_pallas.py": (
        ("test_torch_fused_frames.py", "test_torch_cuda.py"),
        "the Pallas frame kernel's port is a CUDA kernel: its plain "
        "version on the CPU, the kernel itself on the card"),
    "test_reference_parity.py": (
        ("test_torch_chip_geometries.py",),
        "reads the upstream project's artifacts, which the repo does not "
        "carry, and skips without them; chip_smoke.py's snr phase gates "
        "every bundled geometry against float64 on the card"),
    "test_restart.py": (
        ("test_torch_copies.py", "test_torch_web.py"),
        "web/services/restart.py is a verbatim copy; the web's restart "
        "route runs in test_torch_web"),
    "test_shipped_filters.py": (
        ("test_torch_copies.py", "test_torch_fused_frames.py"),
        "checks the shared data/coefficients and engine/selector.py, a "
        "verbatim copy; every shipped sidecar is in the kernel's envelope"),
    "test_sockets.py": (
        ("test_torch_copies.py", "test_torch_stream_cli.py"),
        "io/sockets.py is a verbatim copy; the port's socket e2e is "
        "test_torch_stream_cli"),
    "test_validate_output.py": (
        ("test_torch_copies.py", "test_torch_stream_cli.py"),
        "testing/validate_output.py is a verbatim copy; validate_audio "
        "gates the port's CLI output in test_torch_stream_cli"),
    "test_web_config.py": (
        ("test_torch_copies.py", "test_torch_web_services.py"),
        "web/services/config.py is a verbatim copy; the port's web "
        "services run in test_torch_web_services"),
    "test_web_eq_service.py": (
        ("test_torch_copies.py", "test_torch_web_services.py"),
        "web/services/eq.py is a verbatim copy; the port's web services "
        "run in test_torch_web_services"),
    "test_web_ui.py": (
        ("test_torch_copies.py", "test_torch_web.py"),
        "web/app.py and web/i18n.py are verbatim copies and the templates "
        "byte copies; test_torch_web replays test_web_ui's requests"),
    "test_webserver_cli.py": (
        ("test_torch_copies.py", "test_torch_web.py"),
        "cli/webserver.py is a verbatim copy; test_torch_web serves the "
        "API from totton-web-torch in its own process"),
}

#: Names (``module:name``, ``module:Class.method`` or
#: ``module:function(param)``) that exist only on the TPU, each with its
#: reason. Nothing else of the reference may be missing from the port.
TPU_ONLY = {
    # The XLA formulation knobs of the TPU block step (which DFT program
    # and precision XLA is handed). The port's block step has one
    # formulation: the hand-written kernel on a card, plain torch on the
    # CPU.
    "ops/overlap_save.py:KernelTuning",
    "ops/overlap_save.py:KernelTuning.from_env",
    "ops/overlap_save.py:make_block_step(tuning)",
    "engine/upsampler.py:StreamingUpsampler.__init__(kernel_tuning)",
    "parallel/sharded.py:ShardedUpsampler.__init__(kernel_tuning)",
    "parallel/sharded.py:make_sharded_step(tuning)",
    "serve.py:StreamServer.__init__(kernel_tuning)",
    # Two real DFTs packed into one complex DFT for the MXU's four-step
    # program; the port's kernel packs the real frame itself
    # (csrc/fused_frames.cu).
    "ops/fft.py:fft2_real_split",
    # The stacked four-step forward fed the MXU's tile-absorbed program;
    # the port's plain programs take fft2_real.
    "ops/fft.py:fft2_real_split_stacked",
    # The plain frame function takes the folded bundle (G or the
    # classic spectrum, folded once per filter on its device) where the
    # XLA program takes the spectrum pair and folds it inside the jitted
    # step; the XLA formulation knob goes with it.
    "ops/overlap_save.py:upsample_frames(spectrum)",
    "ops/overlap_save.py:upsample_frames(tuning)",
    "ops/overlap_save.py:upsample_blocks(spectrum)",
    "ops/overlap_save.py:upsample_blocks(tuning)",
    # A jax.random key; torch draws the dither from an integer seed
    # (a jax key has no torch counterpart).
    "ops/device_pcm.py:quantize_s16_dithered(key)",
}


def _modules(root: str) -> list[str]:
    out = []
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        out += [os.path.relpath(os.path.join(d, f), root)
                for f in sorted(files) if f.endswith(".py")]
    return out


def _parse(path: str) -> ast.Module:
    with open(path) as f:
        return ast.parse(f.read())


def _params(fn) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _surface(tree: ast.Module, init: bool) -> dict[str, list[str]]:
    """Public name -> its parameters (functions and methods; [] else);
    methods as ``Class.method``."""
    out: dict[str, list[str]] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = []
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (not m.name.startswith("_")
                             or m.name == "__init__"):
                    out[f"{node.name}.{m.name}"] = _params(m)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id == "__all__" and isinstance(node.value, ast.List):
                    for e in node.value.elts:
                        out.setdefault(e.value, [])
                elif t.id == "_LAZY" and isinstance(node.value, ast.Dict):
                    for k in node.value.keys:
                        out.setdefault(k.value, [])
                else:
                    out[t.id] = []
        elif init and isinstance(node, ast.ImportFrom):
            for a in node.names:
                out.setdefault(a.asname or a.name, [])
    return {k: v for k, v in out.items()
            if not k.split(".")[0].startswith("_")}


def _missing(rel: str) -> set[str]:
    init = rel.endswith("__init__.py")
    ref = _surface(_parse(os.path.join(REF, rel)), init)
    port = _surface(_parse(os.path.join(PORT, rel)), init)
    out = set()
    for name, params in ref.items():
        if name not in port:
            if not name.endswith(".__init__"):
                out.add(f"{rel}:{name}")
            continue
        out |= {f"{rel}:{name}({p})" for p in params
                if p not in port[name]}
    return out


def _compared() -> list[str]:
    return [m for m in _modules(REF) if m not in COUNTERPARTS]


@pytest.mark.parametrize("rel", _compared())
def test_port_has_the_reference_surface(rel):
    """(a) Nothing public of the reference module is missing from the
    port's, outside TPU_ONLY."""
    if not os.path.exists(os.path.join(PORT, rel)):
        pytest.fail(f"{rel} has no counterpart in the port")
    allowed = {n for n in TPU_ONLY if n.startswith(rel + ":")}
    assert _missing(rel) - allowed == set()


def test_tpu_only_names_are_still_missing():
    """Every TPU_ONLY entry names something the reference has and the
    port lacks: a stale entry fails."""
    missing = set()
    for rel in _compared():
        if os.path.exists(os.path.join(PORT, rel)):
            missing |= _missing(rel)
    assert TPU_ONLY <= missing, sorted(TPU_ONLY - missing)


def test_every_reference_module_has_a_counterpart():
    """(b) The port is complete: every module of the reference exists at
    its relative path in the port, or at the COUNTERPARTS path."""
    absent = []
    for rel in _modules(REF):
        paths = COUNTERPARTS.get(rel, [rel])
        absent += [f"{rel} -> {p}" for p in paths
                   if not os.path.exists(os.path.join(PORT, p))]
    assert absent == []
    assert set(COUNTERPARTS) <= set(_modules(REF))


def test_lazy_tables_name_modules_of_the_port():
    """A ``_LAZY`` table maps each name to a module of the port that
    defines it (checked by AST, so the lazy import cannot dangle)."""
    for rel in _modules(PORT):
        tree = _parse(os.path.join(PORT, rel))
        for node in tree.body:
            if not (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "_LAZY"
                            for t in node.targets)):
                continue
            for k, v in zip(node.value.keys, node.value.values):
                target = v.value.replace(".", "/") + ".py"
                assert target.startswith("totton_tpu_torch/"), (rel, k.value)
                path = os.path.join(REPO, target)
                assert os.path.exists(path), (rel, k.value, target)
                assert k.value in _surface(_parse(path), False), (
                    rel, k.value, target)


def test_every_reference_test_file_has_a_twin():
    """(c) Every tests/test_<name>.py of the JAX package has its
    tests/test_torch_<name>.py, or a NO_TWIN entry that names existing
    port tests and gives a reason; an entry whose twin now exists, or
    whose file is gone, fails."""
    tests = os.path.join(REPO, "tests")
    files = set(os.listdir(tests))
    reference = sorted(f for f in files if f.startswith("test_")
                       and f.endswith(".py")
                       and not f.startswith("test_torch_"))
    untwinned = {f for f in reference
                 if "test_torch_" + f[len("test_"):] not in files}
    assert untwinned == set(NO_TWIN), (sorted(untwinned - set(NO_TWIN)),
                                       sorted(set(NO_TWIN) - untwinned))
    for name, (held_by, reason) in NO_TWIN.items():
        assert reason.strip(), name
        assert held_by and all(f in files for f in held_by), (name, held_by)
