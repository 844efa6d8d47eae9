"""chip_smoke.py's geometries against what the product serves, and its
phase ci against the cuda-marked tests it runs.

Every bundled filter's overlap-save geometry must be one that chip_smoke.py
holds the frame kernel to on the card (``PARITY_FILTERS``: parity, the
float64 oracle and a timing each), and so must every filter the CLIs' auto
lookup picks for a ``--ratio`` above 1, at both latencies, both rate
families and both phases. A new bundled filter or ratio with a geometry of
its own fails here until chip_smoke.py runs it. Phase ci must run
tests/test_torch_cuda.py (every cuda-marked test, tests/test_torch_copies.py
checks) without the conftest, and phase 3 may skip a frame count only
where that file's kernel test holds the geometry at it. CPU only; no
kernel.
"""

import ast
import functools
import glob
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import test_torch_cuda  # noqa: E402
from totton_tpu_torch.cli import serve as serve_cli  # noqa: E402
from totton_tpu_torch.cli import stream as stream_cli  # noqa: E402
from totton_tpu_torch.engine.selector import resolve_filter_path  # noqa: E402
from totton_tpu_torch.filters.sidecar import load_filter  # noqa: E402
from totton_tpu_torch.ops.overlap_save import OverlapSaveConfig  # noqa: E402

BUNDLED = sorted(glob.glob(os.path.join(chip_smoke.FILTER_DIR,
                                        "filter_*.json")))
CLIS = {"stream": stream_cli, "serve": serve_cli}


@functools.lru_cache(maxsize=None)
def _cfg(path: str) -> OverlapSaveConfig:
    return OverlapSaveConfig.from_sidecar(load_filter(path).sidecar)


def _checked() -> dict:
    """chip_smoke's geometries: config -> filter name."""
    return {_cfg(os.path.join(chip_smoke.FILTER_DIR, name + ".json")): name
            for name in chip_smoke.PARITY_FILTERS}


def _ratios(cli) -> list[int]:
    """The --ratio choices above 1 of ``cli``'s parser."""
    (action,) = [a for a in cli.build_parser()._actions if a.dest == "ratio"]
    return [r for r in action.choices if r > 1]


def test_chip_geometries_are_distinct_and_the_bundle_has_them_all():
    assert len(BUNDLED) == 32
    assert len(_checked()) == len(chip_smoke.PARITY_FILTERS) == 8
    assert {_cfg(p) for p in BUNDLED} == set(_checked())


@pytest.mark.parametrize("path", BUNDLED, ids=os.path.basename)
def test_bundled_filter_geometry_is_checked_on_the_card(path):
    assert _cfg(path) in _checked()


@pytest.mark.parametrize("latency", ["normal", "low"])
@pytest.mark.parametrize("cli,ratio", [(c, r) for c in CLIS
                                       for r in _ratios(CLIS[c])])
def test_cli_lookup_resolves_to_a_checked_geometry(cli, ratio, latency):
    """Auto lookup (engine/selector.py) at both rate families and phases
    lands on a geometry chip_smoke checks; the 44.1k min-phase pick is
    the very filter it names."""
    checked = _checked()
    for rate in (44100, 48000):
        for phase in ("min", "linear"):
            path = resolve_filter_path(None, chip_smoke.FILTER_DIR, phase,
                                       ratio, rate, latency)
            assert _cfg(path) in checked, path
    pick = resolve_filter_path(None, chip_smoke.FILTER_DIR, "min", ratio,
                               44100, latency)
    assert os.path.basename(pick)[:-5] in chip_smoke.PARITY_FILTERS


def test_cli_runs_on_the_card_take_4x_8x_both_families_and_banks():
    """chip_smoke's CLI runs (CLI_RATIOS) take 4x and 8x, the 48k family
    and the low-latency bank, beside the main path's 16x/80k."""
    runs = chip_smoke.CLI_RATIOS
    assert {r for _, r, _ in runs} == {4, 8}
    assert {rate for rate, _, _ in runs} == {44100, 48000}
    assert {lat for _, _, lat in runs} == {"normal", "low"}
    for rate, ratio, latency in runs:
        assert ratio in _ratios(stream_cli)
        resolve_filter_path(None, chip_smoke.FILTER_DIR, "min", ratio, rate,
                            latency)


def test_ci_phase_runs_the_cuda_tests_without_the_conftest():
    argv = chip_smoke.ci_pytest_argv("x.xml")
    assert argv[1:3] == ["-m", "pytest"]
    assert chip_smoke.CI_TESTS == "tests/test_torch_cuda.py"
    assert chip_smoke.CI_TESTS in argv and "--noconftest" in argv
    assert argv[argv.index("-m", 3) + 1] == "cuda"
    with open(chip_smoke.__file__) as f:
        tree = ast.parse(f.read())
    (main,) = [n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "main"]
    calls = {n.func.id for n in ast.walk(main)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert {"start_wheel", "finish_wheel", "ci_phase"} <= calls


def test_parity_cut_is_held_by_the_cuda_tests(tmp_path):
    """Phase 3 drops CI_FRAME_COUNTS at CI_FILTERS: the cuda test runs
    each of those geometries (the ratio-1 one with a seeded filter) at
    each of those counts."""
    assert chip_smoke.CI_FRAME_COUNTS == tuple(test_torch_cuda.CUDA_FRAME_COUNTS)
    names = set(test_torch_cuda.CUDA_FILTERS)
    served = [f for f in chip_smoke.CI_FILTERS if f.startswith("filter_")]
    assert set(served) <= names and len(served) == 4
    (r1,) = [f for f in chip_smoke.CI_FILTERS if not f.startswith("filter_")]
    assert "ratio1_1025_4096" in names
    labels = [st[0] for st in chip_smoke.ratio1_states(
        "cpu", chip_smoke.write_profile(str(tmp_path)))]
    assert r1 in labels and "(1025, 4096)" in r1
    assert set(chip_smoke.CI_FRAME_COUNTS) <= set(
        chip_smoke.PARITY_FRAMES) | {1024}
