"""The port's file-mode CLI (totton-stream-torch) and session, on the CPU:
validate_audio gates, parity with the JAX CLI, the jax-free import, and
the refusals (no CUDA, flags not ported yet)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from totton_tpu.cli import stream as jax_cli
from totton_tpu.io.devices import AudioSink, WavFileSource
from totton_tpu.io.pcm import PcmFormat, deinterleave, pcm_to_float
from totton_tpu.io.wav import read_wav, write_wav
from totton_tpu.testing.signals import sine
from totton_tpu.testing.validate_output import validate_audio
from totton_tpu_torch.cli import stream as torch_cli
from totton_tpu_torch.engine.upsampler import StreamingUpsampler, upsample_signal
from totton_tpu_torch.io.stream import StreamSession

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _filter16(coefficients_dir):
    return str(next(coefficients_dir.glob("filter_44k_16x_*.json")))


def test_cli_wav_s16_passes_gates_and_matches_jax_cli(coefficients_dir,
                                                      tmp_path):
    fs = 44100
    x = sine(1000.0, 0.25, fs, amplitude=0.5, channels=2)
    in_path = str(tmp_path / "in.wav")
    write_wav(in_path, x, fs)
    common = ["--in", in_path, "--filter", _filter16(coefficients_dir),
              "--format", "s16"]
    stats_path = str(tmp_path / "stats.json")
    assert torch_cli.main(common + ["--out", str(tmp_path / "t.wav"),
                                    "--device", "cpu",
                                    "--stats-path", stats_path]) == 0
    assert jax_cli.main(common + ["--out", str(tmp_path / "j.wav")]) == 0
    yt, rate = read_wav(str(tmp_path / "t.wav"))
    yj, _ = read_wav(str(tmp_path / "j.wav"))
    assert rate == fs * 16
    assert yt.shape == yj.shape == (2, x.shape[1] * 16)
    report = validate_audio(x, yt, output_ratio=16)
    assert report["passed"], report
    lsb = np.abs(np.round(yt * 32768) - np.round(yj * 32768)).max()
    assert lsb <= 1
    with open(stats_path) as f:
        stats = json.load(f)
    assert stats["frames_in"] == x.shape[1]
    assert stats["frames_out"] == x.shape[1] * 16


def test_cli_raw_s32_file_pipeline(coefficients_dir, tmp_path):
    from totton_tpu.io.pcm import float_to_pcm, interleave

    fs = 352800
    x = sine(1000.0, 0.05, fs, amplitude=0.5, channels=2)
    in_path = tmp_path / "in.raw"
    out_path = tmp_path / "out.raw"
    in_path.write_bytes(float_to_pcm(interleave(x), PcmFormat.S32_LE))
    filt = str(next(coefficients_dir.glob("filter_44k_2x_*.json")))
    rc = torch_cli.main(["--in-file", str(in_path), "--out-file",
                         str(out_path), "--rate", str(fs), "--format", "s32",
                         "--filter", filt, "--device", "cpu"])
    assert rc == 0
    y = deinterleave(pcm_to_float(out_path.read_bytes(), PcmFormat.S32_LE), 2)
    assert y.shape[1] == x.shape[1] * 2
    assert validate_audio(x, y, output_ratio=2)["passed"]


class _CaptureSink(AudioSink):
    def __init__(self):
        self.parts = []

    def write_frames(self, frames):
        self.parts.append(np.array(frames))


def test_session_matches_offline(coefficients_dir, rng, tmp_path):
    from totton_tpu.filters.sidecar import load_filter

    lf = load_filter(_filter16(coefficients_dir))
    x = (rng.normal(size=(2, 3000)) * 0.3).astype(np.float32)
    path = str(tmp_path / "in.wav")
    write_wav(path, x, 44100)
    x = read_wav(path)[0]  # the WAV-quantized input both sides see
    sink = _CaptureSink()
    eng = StreamingUpsampler(lf, 2, device="cpu")
    stats = StreamSession(WavFileSource(path), sink, eng,
                          period_frames=500, max_batch_blocks=4).run()
    got = np.concatenate(sink.parts, axis=1)
    ref = upsample_signal(x, lf, device="cpu")
    assert stats.frames_out == ref.shape[1]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_port_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("TOTTON_PLATFORM", "PYTHONPATH")}
    env["PYTHONPATH"] = REPO
    env["TOTTON_COMPILE_CACHE"] = "0"
    code = (
        "import sys, numpy as np, torch\n"
        "import totton_tpu_torch.cli.stream, totton_tpu_torch.io.stream\n"
        "import totton_tpu_torch.serve, totton_tpu_torch.cli.serve\n"
        "from totton_tpu_torch.ops import overlap_save as o, fused_frames as f\n"
        "cfg = o.OverlapSaveConfig(257, 2048, 1792, 4)\n"
        "b = o.fold_bundle(o.filter_spectrum(np.ones(257), 2048), cfg)\n"
        "x = torch.zeros((2, cfg.halo_in + cfg.block_in))\n"
        "assert f.fused_upsample_blocks(x, b, cfg).shape == (2, 1792)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('NOJAX_OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX_OK" in proc.stdout


def test_device_cuda_without_cuda_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = torch_cli.main(["--in", "a.wav", "--out", "b.wav", "--device",
                         "cuda"])
    assert rc == 2
    assert "CUDA is not available" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [
    ["--threaded"], ["--shard-time", "2"], ["--shard-channel", "2"],
    ["--distributed"], ["--crossfeed", "cf.json"],
    ["--control-endpoint", "ipc:///x"], ["--control-pub-endpoint", "tcp://x"],
])
def test_flags_not_ported_exit_2(flag, capsys):
    rc = torch_cli.main(["--in", "a.wav", "--out", "b.wav", "--device",
                         "cpu", *flag])
    assert rc == 2
    assert "not yet ported" in capsys.readouterr().err


def test_missing_endpoints_exit_2(capsys):
    assert torch_cli.main(["--device", "cpu"]) == 2
    assert "required" in capsys.readouterr().err
