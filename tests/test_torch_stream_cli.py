"""The port's CLI (totton-stream-torch) and session, on the CPU:
validate_audio gates, parity with the JAX CLI (file mode, ratio 1 with an
EQ profile, --threaded, --crossfeed, --duration), the jax-free import, the
flags of totton-stream the port carries (the sharded engine included),
the transport-error exit code, and the refusals (no CUDA, a mesh the
devices do not cover)."""

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
from totton_tpu_torch.io.stream import StreamSession, ThreadedStreamSession

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
    """The port's modules, its CLIs, its control and serve-client copies
    and chip_smoke.py load, and a tiny file-mode stream runs on the CPU,
    with neither jax nor any module of the JAX package imported."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("TOTTON_PLATFORM", "PYTHONPATH")}
    env["PYTHONPATH"] = REPO
    env["TOTTON_COMPILE_CACHE"] = "0"
    code = (
        "import sys, numpy as np, torch\n"
        "import totton_tpu_torch.cli.stream, totton_tpu_torch.io.stream\n"
        "import totton_tpu_torch.serve, totton_tpu_torch.cli.serve\n"
        "import totton_tpu_torch.engine.chain, totton_tpu_torch.engine.crossfeed\n"
        "import totton_tpu_torch.control.daemon, totton_tpu_torch.control.client\n"
        "import totton_tpu_torch.control.follower, totton_tpu_torch.control.wiring\n"
        "import totton_tpu_torch.io.serve_client, totton_tpu_torch.filters.hrtf\n"
        "import totton_tpu_torch.parallel, totton_tpu_torch.parallel.dryrun\n"
        "import totton_tpu_torch.utils.profiling\n"
        "import chip_smoke\n"
        "from totton_tpu_torch.ops import overlap_save as o, fused_frames as f\n"
        "cfg = o.OverlapSaveConfig(257, 2048, 1792, 4)\n"
        "b = o.fold_bundle(o.filter_spectrum(np.ones(257), 2048), cfg)\n"
        "x = torch.zeros((2, cfg.halo_in + cfg.block_in))\n"
        "assert f.fused_upsample_blocks(x, b, cfg).shape == (2, 1792)\n"
        "from totton_tpu_torch.control.wiring import resolve_eq_response\n"
        "open('eq.txt', 'w').write('Filter 1: ON PK Fc 1000 Hz Gain 3 dB Q 1')\n"
        "assert resolve_eq_response('eq.txt', None, 4096, 44100)[0].shape "
        "== (2049,)\n"
        "from totton_tpu_torch.io.wav import read_wav, write_wav\n"
        "from totton_tpu_torch.testing.signals import sine\n"
        "write_wav('in.wav', sine(1000.0, 0.2, 44100, channels=2), 44100)\n"
        "rc = totton_tpu_torch.cli.stream.main(['--in', 'in.wav', '--out', "
        "'out.wav', '--eq-profile', 'eq.txt', '--device', 'cpu'])\n"
        "assert rc == 0 and read_wav('out.wav')[0].shape == (2, 8820)\n"
        "rc = totton_tpu_torch.cli.stream.main(['--in', 'in.wav', '--out', "
        "'sh.wav', '--eq-profile', 'eq.txt', '--device', 'cpu', "
        "'--shard-time', '2'])\n"
        "assert rc == 0 and read_wav('sh.wav')[0].shape == (2, 8820)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'totton_tpu'))\n"
        "assert not bad, bad\n"
        "print('NOJAX_OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX_OK" in proc.stdout


@pytest.mark.parametrize("use_config", [False, True])
def test_eq_resolution_equals_the_reference(tmp_path, use_config):
    """The port's resolve_eq_response (its copy of control/wiring.py over
    its own copies of the APO parser and the biquads; the JAX eq package
    loads jax) gives the reference's response bit for bit, from a profile
    path or from config.json."""
    from totton_tpu.control.wiring import resolve_eq_response as ref
    from totton_tpu_torch.control.wiring import resolve_eq_response

    profile = tmp_path / "eq.txt"
    profile.write_text("Preamp: -4 dB\n"
                       "Filter 1: ON PK Fc 1000 Hz Gain 3 dB Q 1.0\n"
                       "Filter 2: ON LSC Fc 100 Hz Gain 2 dB Q 0.7\n"
                       "Filter 3: ON HP Fc 20 Hz Q 0.7\n")
    args = (str(profile), None)
    if use_config:
        cfg = tmp_path / "config.json"
        cfg.write_text(json.dumps({"eqEnabled": True,
                                   "eqProfilePath": str(profile)}))
        args = (None, str(cfg))
    got, desc = resolve_eq_response(*args, 8192, 705600)
    want, want_desc = ref(*args, 8192, 705600)
    np.testing.assert_array_equal(got, want)
    assert desc == want_desc
    assert resolve_eq_response(None, None, 8192, 705600) == (None, None)


def test_device_cuda_without_cuda_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = torch_cli.main(["--in", "a.wav", "--out", "b.wav", "--device",
                         "cuda"])
    assert rc == 2
    assert "CUDA is not available" in capsys.readouterr().err


_REFUSALS = {
    ("--shard-time", "2"): "mesh 1x2 does not cover 1 devices",
    ("--shard-channel", "2", "--shard-time", "1"):
        "mesh 2x1 does not cover 1 devices",
    ("--distributed",): "--distributed needs a sharded engine",
}


@pytest.mark.parametrize("flag", [list(k) for k in _REFUSALS])
def test_flags_not_ported_exit_2(flag, monkeypatch, capsys):
    """The sharding flags exit 2, before any endpoint opens, only where
    the mesh cannot be built: on a one-card machine a mesh of two cells
    does not cover its devices (the JAX package's message), and
    --distributed needs a sharded engine."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    rc = torch_cli.main(["--in", "a.wav", "--out", "b.wav", "--device",
                         "cuda", *flag])
    assert rc == 2
    assert _REFUSALS[tuple(flag)] in capsys.readouterr().err


def test_missing_endpoints_exit_2(capsys):
    assert torch_cli.main(["--device", "cpu"]) == 2
    assert "required" in capsys.readouterr().err


def _wav(tmp_path, rng, n, fs, name="in.wav"):
    x = (rng.normal(size=(2, n)) * 0.2).astype(np.float32)
    path = str(tmp_path / name)
    write_wav(path, x, fs)
    return path, read_wav(path)[0]


def _lsb(a, b):
    return np.abs(np.round(a * 32768) - np.round(b * 32768)).max()


def test_cli_ratio1_eq_profile_matches_jax_cli(tmp_path, rng):
    """--ratio 1 (the default) is the EQ-only mode: the identity filter
    (1025 taps, fft 4096) with an APO profile baked in. Same s16 output
    as the JAX CLI within 1 LSB; the EQ changes the signal."""
    in_path, x = _wav(tmp_path, rng, 20000, 44100)
    profile = tmp_path / "eq.txt"
    profile.write_text("Preamp: -4 dB\n"
                       "Filter 1: ON PK Fc 1000 Hz Gain 3 dB Q 1.0\n"
                       "Filter 2: ON LSC Fc 100 Hz Gain 2 dB Q 0.7\n")
    common = ["--in", in_path, "--format", "s16", "--eq-profile",
              str(profile)]
    assert torch_cli.main(common + ["--out", str(tmp_path / "t.wav"),
                                    "--device", "cpu"]) == 0
    assert jax_cli.main(common + ["--out", str(tmp_path / "j.wav")]) == 0
    yt, rate = read_wav(str(tmp_path / "t.wav"))
    yj, _ = read_wav(str(tmp_path / "j.wav"))
    assert rate == 44100 and yt.shape == yj.shape == x.shape
    assert _lsb(yt, yj) <= 1
    assert _lsb(yt, x) > 100  # the EQ is applied, not a passthrough


def test_cli_threaded_equals_unthreaded_and_jax(coefficients_dir, tmp_path,
                                                rng):
    """--threaded file mode gives the same samples as the synchronous
    session (0 LSB expected, 1 allowed) and as the JAX CLI's threaded
    run (1 LSB)."""
    in_path, x = _wav(tmp_path, rng, 9000, 44100)
    common = ["--in", in_path, "--filter", _filter16(coefficients_dir),
              "--format", "s16"]
    outs = {}
    for name, extra in [("sync", []), ("threaded", ["--threaded"])]:
        out = str(tmp_path / f"{name}.wav")
        assert torch_cli.main(common + extra + ["--out", out, "--device",
                                                "cpu"]) == 0
        outs[name] = read_wav(out)[0]
    assert jax_cli.main(common + ["--threaded", "--out",
                                  str(tmp_path / "j.wav")]) == 0
    yj = read_wav(str(tmp_path / "j.wav"))[0]
    assert outs["threaded"].shape == (2, x.shape[1] * 16)
    assert _lsb(outs["threaded"], outs["sync"]) <= 1
    assert _lsb(outs["threaded"], yj) <= 1


def test_cli_crossfeed_matches_jax_cli(coefficients_dir, tmp_path, rng):
    """--crossfeed (float path: device PCM is off with the chain) against
    the JAX CLI's chain, s16 within 1 LSB; stereo only."""
    from totton_tpu.filters.hrtf import generate_all

    cf = str(generate_all(tmp_path, sizes=["M"], families=["44k"])[0])
    in_path, x = _wav(tmp_path, rng, 7000, 352800)
    common = ["--in", in_path, "--filter-dir", str(coefficients_dir),
              "--ratio", "2", "--format", "s16", "--crossfeed", cf]
    assert torch_cli.main(common + ["--out", str(tmp_path / "t.wav"),
                                    "--device", "cpu"]) == 0
    assert jax_cli.main(common + ["--out", str(tmp_path / "j.wav")]) == 0
    yt, rate = read_wav(str(tmp_path / "t.wav"))
    yj, _ = read_wav(str(tmp_path / "j.wav"))
    assert rate == 705600 and yt.shape == yj.shape == (2, 14000)
    assert _lsb(yt, yj) <= 1
    mono = str(tmp_path / "mono.wav")
    write_wav(mono, x[:1], 352800)
    assert torch_cli.main(["--in", mono, "--out", "null", "--filter-dir",
                           str(coefficients_dir), "--ratio", "2",
                           "--crossfeed", cf, "--device", "cpu"]) == 2


def test_cli_duration_buffer_and_stats(coefficients_dir, tmp_path):
    """--duration stops after that many seconds of input (the reference's
    max_frames); --buffer is accepted (unused, as in the reference)."""
    stats_path = str(tmp_path / "stats.json")
    rc = torch_cli.main(["--in", "null", "--out", "null", "--rate",
                         "352800", "--ratio", "2", "--filter-dir",
                         str(coefficients_dir), "--duration", "0.05",
                         "--buffer", "16384", "--device", "cpu",
                         "--stats-path", stats_path])
    assert rc == 0
    with open(stats_path) as f:
        stats = json.load(f)
    assert stats["frames_in"] == int(0.05 * 352800)
    assert stats["frames_out"] == 2 * stats["frames_in"]


def test_cli_f32_wire_format_is_socket_only(tmp_path, rng, capsys):
    """--format f32 means the raw float32 wire format (fmt None), which
    only socket endpoints speak: a file endpoint fails to open (exit 1,
    as the JAX CLI)."""
    in_path, _ = _wav(tmp_path, rng, 1000, 44100)
    args = ["--in-file", in_path + ".raw", "--out", "null", "--rate",
            "44100", "--format", "f32"]
    assert torch_cli.main(args + ["--device", "cpu"]) == 1
    assert "socket-only" in capsys.readouterr().err
    assert jax_cli.main(args) == 1


def test_cli_passes_socket_reconnect_to_the_source(monkeypatch, tmp_path):
    from totton_tpu_torch.io import devices
    from totton_tpu_torch.io.pcm import PcmFormat as PortPcmFormat

    seen = {}
    real = devices.open_source

    def spy(spec, fmt, channels, rate, socket_reconnect_s=0.0):
        seen.update(fmt=fmt, reconnect=socket_reconnect_s)
        return real(spec, fmt, channels, rate)

    monkeypatch.setattr(devices, "open_source", spy)
    rc = torch_cli.main(["--in", "null", "--out", "null", "--rate", "44100",
                         "--duration", "0.01", "--format", "s16",
                         "--socket-reconnect", "2.5", "--device", "cpu"])
    assert rc == 0
    assert seen == {"fmt": PortPcmFormat.S16_LE, "reconnect": 2.5}


def test_soft_reset_targets_outermost_engine(coefficients_dir, tmp_path,
                                             monkeypatch, rng):
    """With --crossfeed, SOFT_RESET must clear the chain (its FIFO), not
    just the inner upsampler; the leader's daemon publishes on
    --control-pub-endpoint."""
    from totton_tpu.filters.hrtf import generate_all
    from totton_tpu_torch.control import daemon as daemon_mod
    from totton_tpu_torch.engine.chain import CrossfeedChain

    cf = str(generate_all(tmp_path, sizes=["M"], families=["44k"])[0])
    captured = {}

    class FakeDaemon:
        def __init__(self, **kw):
            captured.update(kw)

        def start(self):
            pass

        def stop(self):
            pass

        def wait_for_shutdown(self, timeout=None):
            return True

    monkeypatch.setattr(daemon_mod, "ControlDaemon", FakeDaemon)
    in_path, _ = _wav(tmp_path, rng, 2000, 352800)
    rc = torch_cli.main([
        "--in", in_path, "--out", "null", "--filter-dir",
        str(coefficients_dir), "--ratio", "2", "--crossfeed", cf,
        "--control-endpoint", f"ipc://{tmp_path}/unused.sock",
        "--control-pub-endpoint", f"ipc://{tmp_path}/pub.sock",
        "--device", "cpu"])
    assert rc == 0
    assert isinstance(captured["on_soft_reset"].__self__, CrossfeedChain)
    assert captured["endpoint"] == f"ipc://{tmp_path}/unused.sock"
    assert captured["pub_endpoint"] == f"ipc://{tmp_path}/pub.sock"


def test_transport_error_exits_nonzero(tmp_path):
    """A mid-stream RST on a socket input ends totton-stream-torch with
    exit 1 and the reference's message; an orderly FIN stays exit 0 (the
    port twin of tests/test_stream_cli.py's test)."""
    import socket
    import struct
    import threading
    import time

    from totton_tpu.io.pcm import interleave
    from totton_tpu.io.sockets import pack_header

    env = {k: v for k, v in os.environ.items() if k != "TOTTON_PLATFORM"}
    env["TOTTON_COMPILE_CACHE"] = "0"

    def run_case(rst: bool) -> int:
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        proc = subprocess.Popen(
            [sys.executable, "-m", "totton_tpu_torch.cli.stream",
             "--in", f"tcp-listen://127.0.0.1:{port}", "--out", "null",
             "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO)

        def send():
            deadline = time.monotonic() + 120
            while True:
                try:
                    s = socket.create_connection(("127.0.0.1", port),
                                                 timeout=10)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)
            s.sendall(pack_header(None, 2, 44100))
            s.sendall(interleave(np.zeros((2, 4096), np.float32))
                      .astype("<f4").tobytes())
            time.sleep(0.5)
            if rst:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             struct.pack("ii", 1, 0))
            s.close()

        t = threading.Thread(target=send)
        t.start()
        try:
            rc = proc.wait(timeout=180)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        t.join(timeout=30)
        assert not t.is_alive()
        out = proc.stdout.read()
        if rst:
            assert "transport errors: 1" in out, out[-2000:]
        return rc

    assert run_case(rst=False) == 0
    assert run_case(rst=True) == 1


class _ShardedEngineStub:
    """What a session reads of a sharded engine in a process group: the
    global granule and channel count, and this process's share of
    each."""

    block_input_frames = 4096
    local_block_input_frames = 1024
    channels = 8
    local_channels = 2
    ratio = 2
    device_pcm = None

    class config:
        block_size = 2048


def test_session_feeds_the_engines_local_share():
    """A session on a sharded engine feeds this process's granule and
    channels (local_block_input_frames, local_channels), as the
    reference's session does; before the repair it fed the global ones."""
    from totton_tpu_torch.io.devices import NullSink, NullSource

    eng = _ShardedEngineStub()
    for cls in (StreamSession, ThreadedStreamSession):
        session = cls(NullSource(channels=2), NullSink(), eng,
                      period_frames=4096)
        assert session.block_input_frames == 1024
        assert session.channels == 2
        assert session.period_frames == 1024


def test_cli_sharded_matches_jax_sharded_cli(coefficients_dir, tmp_path,
                                             rng):
    """--shard-time 2 (and a 2x2 mesh) on the CPU against the JAX CLI's
    --shard-time 2 on its virtual devices and the port's plain CLI, on the
    same WAV: within one LSB of each."""
    fs = 44100
    x = (rng.normal(size=(2, 9000)) * 0.2).astype(np.float32)
    in_path = str(tmp_path / "in.wav")
    write_wav(in_path, x, fs)
    common = ["--in", in_path, "--filter", _filter16(coefficients_dir),
              "--format", "s16"]
    outs = {}
    runs = {"time": ["--shard-time", "2"],
            "grid": ["--shard-time", "2", "--shard-channel", "2"],
            "plain": []}
    for name, extra in runs.items():
        out = str(tmp_path / f"{name}.wav")
        assert torch_cli.main(common + ["--out", out, "--device", "cpu"]
                              + extra) == 0
        outs[name] = read_wav(out)[0]
    assert jax_cli.main(common + ["--out", str(tmp_path / "j.wav"),
                                  "--shard-time", "2"]) == 0
    yj = read_wav(str(tmp_path / "j.wav"))[0]
    for name, y in outs.items():
        assert y.shape == yj.shape == (2, x.shape[1] * 16)
        for ref in (yj, outs["plain"]):
            assert np.abs(np.round(y * 32768)
                          - np.round(ref * 32768)).max() <= 1, name


def test_cli_shard_1x1_equals_plain(coefficients_dir, tmp_path, rng):
    """--shard-time 1 --shard-channel 1 is a 1x1 mesh: the plain block
    step on the same input, so the file equals the plain CLI's byte for
    byte."""
    x = (rng.normal(size=(2, 7000)) * 0.2).astype(np.float32)
    in_path = str(tmp_path / "in.wav")
    write_wav(in_path, x, 44100)
    common = ["--in", in_path, "--filter", _filter16(coefficients_dir),
              "--format", "s16", "--device", "cpu"]
    assert torch_cli.main(common + ["--out", str(tmp_path / "s.wav"),
                                    "--shard-time", "1",
                                    "--shard-channel", "1"]) == 0
    assert torch_cli.main(common + ["--out", str(tmp_path / "p.wav")]) == 0
    assert (tmp_path / "s.wav").read_bytes() == (
        tmp_path / "p.wav").read_bytes()


def test_cli_sharded_crossfeed_matches_unsharded(coefficients_dir, tmp_path,
                                                 rng):
    """--shard-time 2 with --crossfeed (tests/test_stream_cli.py's twin):
    the sharded engine wrapped in the chain gives the single-device
    chain's audio."""
    from totton_tpu_torch.filters.hrtf import generate_all

    cf_path = generate_all(tmp_path, sizes=["M"], families=["44k"])[0]
    x = (rng.normal(size=(2, 7000)) * 0.3).astype(np.float32)
    wav_in = str(tmp_path / "in.wav")
    write_wav(wav_in, x, 352800)
    common = ["--in", wav_in, "--filter-dir", str(coefficients_dir),
              "--ratio", "2", "--crossfeed", str(cf_path), "--device", "cpu"]
    assert torch_cli.main(common + ["--out", str(tmp_path / "sharded.wav"),
                                    "--shard-time", "2"]) == 0
    assert torch_cli.main(common + ["--out", str(tmp_path / "plain.wav")]) == 0
    y_sharded, r1 = read_wav(str(tmp_path / "sharded.wav"))
    y_plain, r2 = read_wav(str(tmp_path / "plain.wav"))
    assert r1 == r2 == 705600
    assert y_sharded.shape == y_plain.shape == (2, 14000)
    np.testing.assert_allclose(y_sharded, y_plain, atol=2e-5)
