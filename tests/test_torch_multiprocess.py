"""The port's sharded engine across processes: two gloo ranks through
``python -m totton_tpu_torch.parallel.dryrun --device cpu``, each under a
subprocess timeout of its own (the dry run also times out every child).

Engine mode: each rank feeds only its own block of a time-sharded mesh
(its time span; the boundary halo goes rank to rank) and of a
channel-only mesh (its channel rows), and reproduces the single-process
engine's output at rel < 1e-5; a scheduled swap lands at the same step in
both ranks. Each rank's span is also held against the JAX package's
``ShardedUpsampler`` on the same input (rtol 1e-5, atol 1e-6, the
reference suite's tolerance). --stream mode: totton-stream-torch
--distributed in each rank, the leader's control endpoint and a follower,
and a RELOAD that lands at the same step and granule in both ranks'
output. --cli mode: the CLI over 1x1 to 2x2 CPU meshes against the plain
CLI, within 1 LSB."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6


def _dryrun(*args, timeout, device="cpu"):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "totton_tpu_torch.parallel.dryrun",
         "--timeout", str(timeout - 30),
         *(["--device", device] if device else []), *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)


@pytest.fixture(scope="module")
def engine_run(tmp_path_factory):
    """One engine-mode dry run, each rank's arrays saved: (process, dir)."""
    out = tmp_path_factory.mktemp("dryrun")
    return _dryrun("--save-dir", str(out), timeout=240), out


def test_two_gloo_ranks_reproduce_the_single_process_engine(engine_run):
    proc, out = engine_run
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert "dryrun: PASS" in proc.stdout
    assert proc.stdout.count("landed at step 2") == 2
    assert sorted(os.listdir(out)) == ["rank0.npz", "rank1.npz"]


def _jax_filter(saved):
    from totton_tpu.filters.sidecar import FilterSidecar, LoadedFilter

    taps, fft = saved["taps"], int(saved["fft_size"])
    return LoadedFilter(taps=taps, sidecar=FilterSidecar(
        coefficients_bin="<dryrun>", taps=len(taps), fft_size=fft,
        block_size=fft - (len(taps) - 1),
        upsample_factor=int(saved["ratio"])))


def test_two_gloo_ranks_match_the_jax_sharded_engine(engine_run):
    """Each rank's output, fed only its own block, against the JAX
    package's ShardedUpsampler on the same global input and the same mesh
    shape (conftest's virtual CPU devices), the swap scheduled alike."""
    from totton_tpu.parallel import ShardedUpsampler as JaxSharded
    from totton_tpu.parallel import make_mesh as jax_make_mesh

    proc, out = engine_run
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    ranks = [np.load(out / f"rank{r}.npz") for r in range(2)]
    saved = ranks[0]
    jlf = _jax_filter(saved)
    k = int(saved["time_cols"])

    # Time mesh 1 x k: four steps, the EQ swap scheduled for swap_step.
    x = saved["time_x"]
    eng = JaxSharded(jlf, jax_make_mesh(1, k, jax.devices()[:k]), channels=2)
    eng.schedule_swap(eq_response=saved["eq"],
                      apply_at_step=int(saved["swap_step"]))
    step = eng.block_input_frames
    want = np.concatenate([eng.process_block(x[:, i:i + step])
                           for i in range(0, x.shape[1], step)], axis=1)
    ratio = int(saved["ratio"])
    for r, got in enumerate(ranks):
        lo, span = int(got["time_lo"]), int(got["time_span"])
        cols = [want[:, (i + lo) * ratio:(i + lo + span) * ratio]
                for i in range(0, x.shape[1], step)]
        np.testing.assert_allclose(got["time_y"], np.concatenate(cols, 1),
                                   rtol=RTOL, atol=ATOL, err_msg=f"rank {r}")

    # Channel mesh k x 1: each rank its own rows.
    x = saved["channel_x"]
    eng = JaxSharded(jlf, jax_make_mesh(k, 1, jax.devices()[:k]),
                     channels=k)
    step = eng.block_input_frames
    want = np.concatenate([eng.process_block(x[:, i:i + step])
                           for i in range(0, x.shape[1], step)], axis=1)
    for r, got in enumerate(ranks):
        rows = got["channel_rows"]
        np.testing.assert_allclose(got["channel_y"],
                                   want[rows[0]:rows[-1] + 1],
                                   rtol=RTOL, atol=ATOL, err_msg=f"rank {r}")


def test_two_gloo_ranks_stream_with_a_synchronized_reload():
    proc = _dryrun("--stream", "--seconds", "2", timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    assert "dryrun --stream: PASS" in proc.stdout


def test_cli_over_cpu_meshes_matches_the_plain_cli():
    proc = _dryrun("--cli", "--seconds", "1", timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert "dryrun --cli: PASS" in proc.stdout
    for mesh in ("1x1", "1x2", "1x4", "2x1", "2x2"):
        assert f"mesh {mesh}: " in proc.stdout


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without CUDA")
def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu():
    proc = _dryrun(timeout=60, device=None)
    assert proc.returncode == 2
    assert "CUDA is not available" in proc.stderr
    assert "PASS" not in proc.stdout
