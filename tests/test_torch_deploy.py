"""The port's deployment layer (deploy/torch, scripts/torch, release/torch)
and its CI workflow (.github/workflows/ci-torch.yml) on the CPU.

Drift: each ported file is held to its JAX counterpart after the name
mapping (``to_port``): shell scripts, Dockerfiles and the workflow line
by line, where
every hunk that differs must carry a ``seam: <name>`` tag; systemd units
through configparser and compose files through yaml, where every key that
differs must be a seam. The seams are the ones the file's header
declares (``seam <name>: reason``), no more and no fewer. Static checks:
no port file names a JAX CLI, the JAX package or its platform switch;
the compose GPU reservations; the web restart hooks name the port's DSP
container and unit; every Dockerfile COPY source exists; the image's
prebuild names every kernel source; the workflow parses, every script it
runs exists and is executable, it runs all six of the port's console
scripts and no other, checks that jax and torch import before the tests,
and pins torch to the development image's version. The entrypoint's
modes run in
test_torch_deploy_services.py; its stream mode is held here to the port's
CLI (byte-equal) and to the JAX entrypoint (<= 1 LSB at s16)."""

import configparser
import difflib
import os
import re
import shlex
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from totton_tpu.io.wav import read_wav as jax_read_wav  # noqa: E402
from totton_tpu_torch.cli import stream as torch_cli  # noqa: E402
from totton_tpu_torch.io.wav import read_wav, write_wav  # noqa: E402

torch.set_num_threads(2)

# Each ported file and its reference.
REF_OF = {
    "deploy/torch/entrypoint.sh": "deploy/entrypoint.sh",
    "deploy/torch/Dockerfile": "deploy/Dockerfile",
    "deploy/torch/Dockerfile.dev": "deploy/Dockerfile.dev",
    "deploy/torch/docker-compose.yml": "deploy/docker-compose.yml",
    "deploy/torch/docker-compose.dev.yml": "deploy/docker-compose.dev.yml",
    "deploy/torch/docker-compose.test.yml": "deploy/docker-compose.test.yml",
    "deploy/torch/systemd/totton-dsp-torch.service":
        "deploy/systemd/totton-dsp.service",
    "deploy/torch/systemd/totton-serve-torch.service":
        "deploy/systemd/totton-serve.service",
    "deploy/torch/systemd/totton-web-torch.service":
        "deploy/systemd/totton-web.service",
    "scripts/torch/e2e_local_file_test.sh": "scripts/e2e_local_file_test.sh",
    "scripts/torch/e2e_docker_test.sh": "scripts/e2e_docker_test.sh",
    "scripts/torch/run_tests.sh": "scripts/run_tests.sh",
    ".github/workflows/ci-torch.yml": ".github/workflows/ci.yml",
}
CI = ".github/workflows/ci-torch.yml"
# The port's other deployment files: the quickstart, the lock script and
# the lock it wrote on the card's machine.
OTHERS = ["release/torch/START_HERE.md", "scripts/torch/freeze_lock.py",
          "deploy/torch/requirements-torch-lock.txt"]
PORT_DIRS = ("deploy/torch", "scripts/torch", "release/torch")

_PORTED_PATH = re.compile(
    r"\b(deploy|scripts|release)/(systemd/|entrypoint\.sh|Dockerfile|"
    r"docker-compose|e2e_local_file_test\.sh|e2e_docker_test\.sh|"
    r"run_tests\.sh|START_HERE\.md)")
_JAX_CLI = re.compile(
    r"\btotton-(stream|serve-client|serve|control|web|generate-filters)"
    r"(?![\w-])")
_DECLARED = re.compile(r"^#\s+seam ([^\s:]+):")
_TAG = re.compile(r"#\s*seam:\s*([\w-]+)")


def _read(rel: str) -> str:
    with open(os.path.join(REPO, rel)) as f:
        return f.read()


def to_port(text: str) -> str:
    """The reference's text with the port's names: the ported files by
    their port paths, the package, the install root and image names
    (totton-tpu -> totton-tpu-torch), the CLIs, units and containers
    (totton-X -> totton-X-torch), and the platform switch by the port's
    device switch, TOTTON_DEVICE."""
    text = _PORTED_PATH.sub(lambda m: f"{m[1]}/torch/{m[2]}", text)
    text = text.replace("TOTTON_PLATFORM", "TOTTON_DEVICE")
    text = re.sub(r"\btotton_tpu\b", "totton_tpu_torch", text)
    text = re.sub(r"\btotton-tpu\b", "totton-tpu-torch", text)
    return re.sub(
        r"\btotton-(stream|serve-client|serve|control|web|generate-filters|"
        r"dsp-test|web-test|dsp)(?![\w-])", r"totton-\1-torch", text)


def _header_and_body(text: str) -> tuple[list[str], list[str]]:
    """(the leading comment lines, the rest without leading blanks)."""
    lines = text.splitlines()
    n = 0
    while n < len(lines) and lines[n].startswith("#"):
        n += 1
    body = lines[n:]
    while body and not body[0].strip():
        body.pop(0)
    return lines[:n], body


def declared_seams(rel: str) -> set[str]:
    return {m[1] for line in _header_and_body(_read(rel))[0]
            if (m := _DECLARED.match(line))}


def _line_seams(rel: str, text: str | None = None) -> set[str]:
    """The tags of the hunks in which ``rel`` (or ``text`` in its place)
    differs from its mapped reference; fails on a hunk with none."""
    ref = _header_and_body(to_port(_read(REF_OF[rel])))[1]
    port = _header_and_body(_read(rel) if text is None else text)[1]
    used = set()
    ops = difflib.SequenceMatcher(None, ref, port, autojunk=False)
    for op, i1, i2, j1, j2 in ops.get_opcodes():
        if op == "equal":
            continue
        tags = {t for line in port[j1:j2] for t in _TAG.findall(line)}
        assert tags, (f"{rel}: untagged difference\n- "
                      + "\n- ".join(ref[i1:i2]) + "\n+ "
                      + "\n+ ".join(port[j1:j2]))
        used |= tags
    return used


class _Multi(dict):
    """configparser options that may repeat (systemd's Environment=)."""

    def __setitem__(self, key, value):
        if isinstance(value, list) and key in self:
            self[key].extend(value)
        else:
            super().__setitem__(key, value)


def unit_items(text: str) -> dict[str, str]:
    """'Section.Key' -> value of a unit file, each Environment=
    assignment as 'Section.Environment.NAME'."""
    cp = configparser.ConfigParser(strict=False, interpolation=None,
                                   dict_type=_Multi, delimiters=("=",))
    cp.optionxform = str
    cp.read_string(text)
    out = {}
    for sect in cp.sections():
        for key, value in cp[sect].items():
            if key != "Environment":
                out[f"{sect}.{key}"] = value
                continue
            for line in value.splitlines():
                for a in shlex.split(line):
                    name, _, v = a.partition("=")
                    out[f"{sect}.Environment.{name}"] = v
    return out


def _flat(node, prefix=""):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: node}


def _compose(text: str) -> dict:
    yaml = pytest.importorskip("yaml")
    return yaml.safe_load(text)


def _keyed_seams(rel: str, text: str | None = None) -> set[str]:
    """The keys in which the unit or compose file ``rel`` (or ``text`` in
    its place) differs from its mapped reference."""
    text = _read(rel) if text is None else text
    if rel.endswith(".service"):
        a, b = unit_items(to_port(_read(REF_OF[rel]))), unit_items(text)
    else:
        a, b = _flat(_compose(to_port(_read(REF_OF[rel])))), _flat(
            _compose(text))
    return {k for k in set(a) | set(b) if a.get(k) != b.get(k)}


def test_port_deployment_files_are_known():
    """Every file under the port's deployment directories is a ported
    file (held by the drift check) or one of OTHERS."""
    found = []
    for d in PORT_DIRS:
        for root, dirs, files in os.walk(os.path.join(REPO, d)):
            dirs[:] = [x for x in dirs if x != "__pycache__"]
            found += [os.path.relpath(os.path.join(root, f), REPO)
                      for f in files]
    ported = [r for r in REF_OF if r.startswith(PORT_DIRS)]
    assert sorted(found) == sorted([*ported, *OTHERS])


@pytest.mark.parametrize("rel", sorted(REF_OF))
def test_port_file_differs_from_reference_only_in_its_seams(rel):
    declared = declared_seams(rel)
    if rel.endswith(".service") or "docker-compose" in rel:
        assert _keyed_seams(rel) == declared
    else:
        assert _line_seams(rel) == declared


def test_name_mapping():
    """The mapping the drift check applies to a reference's text."""
    assert to_port(
        "totton-stream totton-serve-client totton-dsp-test totton-dsp.service "
        "python -m totton_tpu.cli.stream /opt/totton-tpu/config.json "
        "totton-tpu-dev:latest deploy/Dockerfile.dev deploy/systemd/x "
        "release/config.example.json totton-stream-torch "
        "TOTTON_PLATFORM=cpu") == (
        "totton-stream-torch totton-serve-client-torch totton-dsp-test-torch "
        "totton-dsp-torch.service python -m totton_tpu_torch.cli.stream "
        "/opt/totton-tpu-torch/config.json totton-tpu-torch-dev:latest "
        "deploy/torch/Dockerfile.dev deploy/torch/systemd/x "
        "release/config.example.json totton-stream-torch "
        "TOTTON_DEVICE=cpu")


def test_drift_check_catches_an_untagged_change():
    """A changed line with no seam tag fails the line check; a changed
    unit key shows among the keyed differences."""
    rel = "deploy/torch/entrypoint.sh"
    text = _read(rel).replace('WEB_PORT="${TOTTON_WEB_PORT:-8080}"',
                              'WEB_PORT="${TOTTON_WEB_PORT:-8081}"')
    with pytest.raises(AssertionError, match="untagged difference"):
        _line_seams(rel, text)
    unit = "deploy/torch/systemd/totton-dsp-torch.service"
    text = _read(unit).replace("RestartSec=5", "RestartSec=6")
    assert "Service.RestartSec" in _keyed_seams(unit, text)


@pytest.mark.parametrize("rel", sorted([*REF_OF, *OTHERS]))
def test_port_file_names_nothing_of_the_jax_deployment(rel):
    """No JAX CLI, no JAX package, no TOTTON_PLATFORM; the reference
    files' own paths (deploy/..., scripts/...) may be named."""
    text = re.sub(r"\b(deploy|scripts|release)/[\w./{},-]+", "", _read(rel))
    assert not _JAX_CLI.search(text), _JAX_CLI.search(text)[0]
    assert not re.search(r"\btotton_tpu\b", text)
    assert "TOTTON_PLATFORM" not in text


def test_compose_reserves_a_gpu_for_dsp_and_serve_only():
    services = _compose(_read("deploy/torch/docker-compose.yml"))["services"]
    gpu = {"driver": "nvidia", "count": 1, "capabilities": ["gpu"]}
    for name in ("dsp", "serve"):
        devices = services[name]["deploy"]["resources"]["reservations"][
            "devices"]
        assert devices == [gpu], name
    assert "deploy" not in services["web"]
    assert services["web"]["environment"]["CUDA_VISIBLE_DEVICES"] == ""


@pytest.mark.parametrize("rel, dsp, web", [
    ("docker-compose.yml", "dsp", "web"),
    ("docker-compose.test.yml", "dsp-test", "web-test"),
])
def test_web_restart_hook_names_the_port_dsp_container(rel, dsp, web):
    port = _compose(_read(f"deploy/torch/{rel}"))["services"]
    ref = _compose(_read(f"deploy/{rel}"))["services"]
    name = port[dsp]["container_name"]
    assert port[web]["environment"]["TOTTON_DSP_CONTAINER"] == name
    assert name != ref[dsp]["container_name"]


@pytest.mark.parametrize("rel", ["deploy/torch/Dockerfile",
                                 "deploy/torch/Dockerfile.dev"])
def test_dockerfile_copy_sources_exist(rel):
    """Every COPY source exists in the build context (the repository
    root, as the compose files set it)."""
    copies = [shlex.split(line)[1:-1] for line in _read(rel).splitlines()
              if line.startswith("COPY ")]
    for sources in copies:
        for src in sources:
            assert os.path.exists(os.path.join(REPO, src)), src
    if rel.endswith("Dockerfile"):
        assert ["deploy/torch/entrypoint.sh"] in copies


def test_prebuild_names_every_kernel_and_builds_into_the_image():
    text = _read("deploy/torch/Dockerfile")
    cmd = chip_smoke.prebuild_command()
    stems = sorted(f[:-3] for f in os.listdir(
        os.path.join(REPO, "totton_tpu_torch", "csrc")) if f.endswith(".cu"))
    assert stems == sorted(chip_smoke.KERNELS)
    for stem in stems:
        assert f"'{stem}'" in cmd
    assert "native.available()" in cmd
    env = text.index("ENV TOTTON_TORCH_BUILD_DIR=/opt/totton-tpu-torch/")
    assert env < text.index(cmd) < text.index("ENTRYPOINT")
    assert text.index("COPY totton_tpu_torch") < text.index(cmd)


def test_web_unit_restarts_the_port_dsp_unit():
    web = unit_items(_read("deploy/torch/systemd/totton-web-torch.service"))
    assert web["Service.Environment.TOTTON_RESTART_CMD"] == (
        "systemctl restart totton-dsp-torch.service")
    assert web["Service.Environment.CUDA_VISIBLE_DEVICES"] == ""
    assert os.path.exists(os.path.join(
        REPO, "deploy/torch/systemd/totton-dsp-torch.service"))


@pytest.mark.parametrize("unit", ["dsp", "serve", "web"])
def test_unit_runs_the_port_entrypoint(unit):
    """ExecStart is the port's entrypoint under the install root, in the
    mode of its name; chip_smoke reads the same argv and environment."""
    argv, env = chip_smoke.unit_service(f"totton-{unit}-torch.service")
    assert argv == [chip_smoke.ENTRYPOINT, unit]
    assert env["TOTTON_CONFIG_PATH"] == os.path.join(REPO, "config.json")


@pytest.mark.skipif(shutil.which("systemd-analyze") is None,
                    reason="systemd-analyze is not installed")
def test_units_pass_systemd_analyze(tmp_path):
    """systemd's own check of the three units, ExecStart pointed at this
    checkout's entrypoint."""
    paths = []
    for unit in ("dsp", "serve", "web"):
        name = f"totton-{unit}-torch.service"
        text = _read(f"deploy/torch/systemd/{name}").replace(
            chip_smoke.INSTALL_ROOT, REPO)
        (tmp_path / name).write_text(text)
        paths.append(str(tmp_path / name))
    proc = subprocess.run(["systemd-analyze", "verify", *paths],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and not proc.stderr.strip(), proc.stderr


@pytest.mark.parametrize("rel", [r for r in REF_OF if r.endswith(".sh")])
def test_scripts_are_executable(rel):
    assert os.access(os.path.join(REPO, rel), os.X_OK)


# ---- the port's CI workflow ------------------------------------------------


def _ci_runs() -> dict[str, list[str]]:
    """job -> the ``run`` commands of its steps, as the workflow's yaml
    reads them."""
    jobs = _compose(_read(CI))["jobs"]
    return {name: [step["run"] for step in job["steps"] if "run" in step]
            for name, job in jobs.items()}


def test_ci_jobs_and_triggers():
    """The reference's triggers and Python matrix; the test job and the
    wheel job, and no docker job (the port's compose needs a GPU)."""
    port, ref = _compose(_read(CI)), _compose(_read(REF_OF[CI]))
    # yaml reads the bare key "on" as True.
    assert port[True] == ref[True]
    assert sorted(port["jobs"]) == ["test", "wheel"]
    assert port["jobs"]["test"]["strategy"] == ref["jobs"]["test"]["strategy"]


def test_ci_scripts_exist_and_are_executable():
    scripts = {m for runs in _ci_runs().values() for run in runs
               for m in re.findall(r"\bscripts/[\w/.-]+\.sh\b", run)}
    assert scripts == {"scripts/torch/run_tests.sh",
                       "scripts/torch/e2e_local_file_test.sh"}
    for rel in scripts:
        assert os.access(os.path.join(REPO, rel), os.X_OK), rel


def test_ci_runs_every_port_console_script():
    """The wheel job runs each of pyproject's six -torch scripts, and no
    other, from the venv it installed the wheel into."""
    runs = "\n".join(_ci_runs()["wheel"])
    ran = set(re.findall(r"/bin/(totton-[\w-]+) --help", runs))
    ours = {n for n in chip_smoke.console_scripts() if n.endswith("-torch")}
    assert len(ours) == 6 and ran == ours
    assert "assert 'jax' not in sys.modules" in runs


def test_ci_checks_both_imports_before_the_tests():
    """Without torch every port test file skips and the job would pass
    having run nothing: the install is checked first."""
    runs = _ci_runs()["test"]
    check = runs.index('python -c "import jax, torch"')
    assert check < runs.index("bash scripts/torch/run_tests.sh")
    assert "TOTTON_DEVICE=cpu bash scripts/torch/e2e_local_file_test.sh" in (
        runs)


def test_ci_torch_pin_is_the_dev_image_version():
    pins = re.findall(r"torch==([\w.+]+)", _read(CI))
    (dev,) = re.findall(r"^ARG TORCH_VERSION=(\S+)$",
                        _read("deploy/torch/Dockerfile.dev"), re.M)
    assert len(pins) == 2 and set(pins) == {dev}
    assert _read(CI).count(
        "--index-url https://download.pytorch.org/whl/cpu") == 2


# ---- the entrypoint's stream mode --------------------------------------


@pytest.fixture
def deploy(tmp_path):
    """(env for the entrypoint, its directories): console-script wrappers
    of the port's CLIs and of totton-stream on PATH (each logs its
    argv), config.json a copy of release/config.example.json, the
    bundled 8k bank's 16x and 2x filters, 2-thread children."""
    bin_dir, argv_dir = tmp_path / "bin", tmp_path / "argv"
    argv_dir.mkdir()
    names = [n for n in chip_smoke.console_scripts() if n.endswith("-torch")]
    chip_smoke.write_shims(str(bin_dir), names + ["totton-stream"],
                           str(argv_dir))
    filters = tmp_path / "coeff"
    filters.mkdir()
    for name in os.listdir(chip_smoke.FILTER_DIR):
        if re.match(r"filter_44k_(16|2)x_8000_(min|linear)_phase\.", name):
            os.symlink(os.path.join(chip_smoke.FILTER_DIR, name),
                       filters / name)
    cfg = tmp_path / "config.json"
    shutil.copyfile(os.path.join(REPO, "release", "config.example.json"), cfg)
    env = {k: v for k, v in os.environ.items() if not k.startswith("TOTTON_")}
    env.update(
        PATH=os.pathsep.join([str(bin_dir), os.path.dirname(sys.executable),
                              env.get("PATH", "")]),
        PYTHONPATH=REPO, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2",
        TOTTON_CONFIG_PATH=str(cfg), TOTTON_FILTER_DIR=str(filters),
        TOTTON_STATS_PATH=str(tmp_path / "stats.json"),
        TOTTON_EQ_DIR=str(tmp_path / "EQ"),
        TOTTON_DATA_DIR=str(tmp_path / "data"), TOTTON_COMPILE_CACHE="0")
    return env, tmp_path


def run_entry(env, mode, log_path, entry=chip_smoke.ENTRYPOINT,
              timeout=240):
    """(exit code, output) of the entrypoint in ``mode``, run to its end
    in its own process group, which is killed afterwards."""
    proc = chip_smoke.start_entry([entry, mode], env, str(log_path))
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        chip_smoke.kill_group(proc)
    return rc, log_path.read_text()


def _stereo(seconds, seed):
    r = np.random.default_rng(seed)
    t = np.arange(int(seconds * 44100)) / 44100
    x = np.stack([0.4 * np.sin(2 * np.pi * 440 * t),
                  0.3 * np.sin(2 * np.pi * 660 * t)])
    return (x + r.normal(size=x.shape) * 0.02).astype(np.float32)


def test_stream_mode_matches_cli_and_jax_entrypoint(deploy):
    """``entrypoint.sh stream``: TOTTON_RATIO=16 wins over config.json's
    ratio 2; the output is byte-equal to cli.stream.main run with the
    arguments the entrypoint passed, and <= 1 LSB (s16) from the JAX
    entrypoint's on the same input."""
    env, tmp = deploy
    write_wav(str(tmp / "in.wav"), _stereo(1.0, 0), 44100)
    x = read_wav(str(tmp / "in.wav"))[0]
    env.update(TOTTON_DEVICE="cpu", TOTTON_IN=str(tmp / "in.wav"),
               TOTTON_OUT=str(tmp / "ep.wav"), TOTTON_RATIO="16",
               TOTTON_FORMAT="S16_LE")
    rc, out = run_entry(env, "stream", tmp / "stream.log")
    assert rc == 0, out
    args = (tmp / "argv" / "totton-stream-torch.argv").read_text().split("\n")
    args = args[:-1]
    assert args[:2] == ["--device", "cpu"] and "--ratio" in args
    assert args[args.index("--ratio") + 1] == "16"
    assert args[args.index("--format") + 1] == "S16_LE"
    args[args.index("--out") + 1] = str(tmp / "main.wav")
    args[args.index("--stats-path") + 1] = str(tmp / "main.json")
    assert torch_cli.main(args) == 0
    assert (tmp / "ep.wav").read_bytes() == (tmp / "main.wav").read_bytes()

    jenv = dict(env, TOTTON_PLATFORM="cpu", JAX_PLATFORMS="cpu",
                TOTTON_OUT=str(tmp / "jax.wav"))
    rc, out = run_entry(jenv, "stream", tmp / "jax.log",
                        entry=os.path.join(REPO, "deploy", "entrypoint.sh"))
    assert rc == 0, out
    y, rate = read_wav(str(tmp / "ep.wav"))
    yj, rate_j = jax_read_wav(str(tmp / "jax.wav"))
    assert rate == rate_j == 16 * 44100
    assert y.shape == yj.shape == (2, 16 * x.shape[1])
    assert np.abs(np.round(y * 32768) - np.round(yj * 32768)).max() <= 1


def test_stream_mode_takes_config_ratio_without_env(deploy):
    """Without TOTTON_RATIO the ratio is config.json's (2)."""
    env, tmp = deploy
    write_wav(str(tmp / "in.wav"), _stereo(0.5, 1), 44100)
    env.update(TOTTON_DEVICE="cpu", TOTTON_IN=str(tmp / "in.wav"),
               TOTTON_OUT=str(tmp / "out.wav"))
    rc, out = run_entry(env, "stream", tmp / "stream.log")
    assert rc == 0, out
    y, rate = read_wav(str(tmp / "out.wav"))
    assert rate == 2 * 44100 and y.shape == (2, 2 * 22050)
    args = (tmp / "argv" / "totton-stream-torch.argv").read_text().split()
    assert args[args.index("--ratio") + 1] == "2"
    assert args[args.index("--format") + 1] == "S32_LE"


def test_unknown_mode_exits_2(deploy):
    env, tmp = deploy
    rc, out = run_entry(env, "bogus", tmp / "bogus.log", timeout=60)
    assert rc == 2 and "unknown mode: bogus" in out


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without CUDA")
def test_stream_mode_without_device_refuses_the_cpu(deploy):
    """TOTTON_DEVICE unset means cuda: without a card the CLI exits 2 and
    so does the entrypoint; it never runs on the CPU by itself."""
    env, tmp = deploy
    write_wav(str(tmp / "in.wav"), _stereo(0.1, 2), 44100)
    env.update(TOTTON_IN=str(tmp / "in.wav"), TOTTON_OUT=str(tmp / "o.wav"))
    rc, out = run_entry(env, "stream", tmp / "stream.log")
    assert rc == 2, out
    assert "CUDA is not available" in out
    assert not (tmp / "o.wav").exists()
