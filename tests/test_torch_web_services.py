"""Port parity: the web layer's services (``web/services/{eq,config,
daemon,restart}.py``, copies of the JAX package's) against the
reference's on the reference suites' inputs (tests/test_web_eq_service.py,
tests/test_web_config.py, tests/test_restart.py): the same results, and
the same files written."""

import dataclasses
import importlib
import json

import pytest

torch = pytest.importorskip("torch")

PACKAGES = ("totton_tpu", "totton_tpu_torch")


def _both(name: str):
    return [importlib.import_module(f"{pkg}.web.services.{name}")
            for pkg in PACKAGES]


def _plain(value):
    if dataclasses.is_dataclass(value):
        value = dataclasses.asdict(value)
    return json.loads(json.dumps(value, default=str, sort_keys=True))


BAND_LINES = [
    "Filter 3: ON PK Fc 1000 Hz Gain -3.5 dB Q 1.41",
    "Filter 1: OFF HPQ Fc 50 Hz Q 0.7",
    "Filter: ON LS 6DB Fc 105 Hz Gain 2 dB",
    "Filter 2: ON PK Fc 250 Hz Gain 1 dB BW Oct 0.5",
    "Filter 2: ON PK Fc 1000 Hz Gain 1 dB BW 500 Hz",
    "Filter 1: ON PK Fc 1000Hz Gain 1 dB Q 1",
    "Filter 1: ON PK Fc 2 kHz Gain 1 dB Q 1",
    "Filter 1: ON PK Fc 2kHz Gain 1 dB Q 1",
    "Preamp: -6 dB",
    "Filter 1: MAYBE PK Fc 100 Hz",
    "Filter 1: ON PK",
    "Filter 1: ON PK Fc abc Hz",
    "Filter 9: ON PK Fc 5366 Hz Gain 2.8 dB Q 1.5",
    "Filter 9: ON PK Fc 5366 Hz Gain -9 dB Q 1.5",
]


@pytest.mark.parametrize("line", BAND_LINES)
def test_scan_band_line_equal(line):
    out = []
    for eq in _both("eq"):
        band = eq.scan_band_line(line)
        out.append(None if band is None else [
            _plain(band), band.effective_q(), eq.is_correction_band(band)])
    assert out[0] == out[1]


@pytest.mark.parametrize("line", ["Preamp: -6 dB", "Preamp: -6dB",
                                  "Preamp: -6", "Preamp: -6 dB extra"])
def test_scan_preamp_equal(line):
    a, b = (eq._scan_preamp(line) for eq in _both("eq"))
    assert a == b


PROFILES = [
    "Filter 1: ON PK Fc 100 Hz Gain 1 dB Q 1",
    "Preamp: -2 dB\nFilter 1: ON PK Fc 100 Hz Gain 1 dB\n"
    "Filter 2: ON LP Fc 8000 Hz\n",
    "Preamp: 0 dB\nFilter 1: ON LSC Fc 100 Hz\n",
    "Preamp: -200 dB\nFilter 1: ON PK Fc 5 Hz Gain 50 dB Q 500\n",
    "Preamp: 0 dB\nFilter 1: ON PK Fc 100 Hz Gain 4 dB Q 1\n"
    "Filter 2: OFF PK Fc 200 Hz Gain 9 dB Q 1\n",
    "Preamp: 0 dB\nFilter 1: ON XYZ Fc 100 Hz\n",
    "Preamp: 0 dB\nFilter 1: garbage here\n",
    "  \n ",
    "\n".join(["Preamp: 0 dB"] + [
        f"Filter {i}: ON PK Fc 100 Hz Gain 1 dB Q 1" for i in range(120)]),
]


@pytest.mark.parametrize("text", PROFILES)
def test_validate_profile_equal(text):
    a, b = (eq.validate_eq_profile_content(text) for eq in _both("eq"))
    assert a == b


@pytest.mark.parametrize("name", ["my_eq-1.2", "../etc/passwd", ".hidden"])
def test_profile_name_safety_equal(name):
    a, b = (eq.is_safe_profile_name(name) for eq in _both("eq"))
    assert a == b


@pytest.mark.parametrize("name", ["dir/sub\\evil.txt", "a..b.txt",
                                  "ok-1_2.txt"])
def test_sanitize_filename_equal(name):
    a, b = (eq.sanitize_filename(name) for eq in _both("eq"))
    assert a == b


@pytest.mark.parametrize("name,content", [
    ("x.exe", b"Preamp: 0 dB"), ("x.txt", b"\xff\xfe\x00bad"),
    ("p.txt", b"Preamp: -1 dB\nFilter 1: ON PK Fc 100 Hz Gain 1 dB Q 1\n"),
])
def test_validate_upload_equal(name, content):
    out = []
    for eq in _both("eq"):
        try:
            out.append(_plain(eq.validate_upload(name, content)))
        except ValueError as e:
            out.append(f"ValueError: {e}")
    assert out[0] == out[1]


STRUCTURED = {
    "opra": ("# OPRA: Maker Model\n# Author: Someone\n"
             "# License: CC BY-SA 4.0\n"
             "# Details: oratory1990 preset + Modern Target (KB5000_7)\n"
             "Preamp: -9.2 dB\nFilter 1: ON PK Fc 100 Hz Gain 2 dB Q 1.0\n"
             "Filter 2: ON PK Fc 5366 Hz Gain 2.8 dB Q 1.5\n"),
    "custom": "Preamp: 0 dB\nFilter 1: ON PK Fc 100 Hz Gain 1 dB Q 1\n",
    "missing": None,
}


@pytest.mark.parametrize("kind", sorted(STRUCTURED))
def test_structured_view_equal(kind, tmp_path):
    f = tmp_path / "p.txt"
    if STRUCTURED[kind] is not None:
        f.write_text(STRUCTURED[kind])
    a, b = (_plain(eq.parse_eq_profile_content(f)) for eq in _both("eq"))
    assert a == b


def _config_ops(pkg, root, monkeypatch, op):
    monkeypatch.setenv("TOTTON_CONFIG_PATH", str(root / "config.json"))
    monkeypatch.setenv("TOTTON_EQ_DIR", str(root / "EQ"))
    cfg = importlib.import_module(f"{pkg}.web.services.config")
    path = root / "config.json"
    if op == "round_trip":
        (root / "EQ").mkdir()
        (root / "EQ" / "p.txt").write_text("Preamp: -1 dB")
        cfg.save_config(cfg.Settings(
            eq_enabled=True, eq_profile="p",
            eq_profile_path=str(root / "EQ" / "p.txt"),
            alsa=cfg.AlsaSettings(
                input_device="null", output_device="null",
                sample_rate=44100, channels=2, format="S32_LE",
                period_frames=4096, buffer_frames=16384),
            filter=cfg.FilterSettings(ratio=16, phase_type="minimum",
                                      directory="data/coefficients")))
    elif op == "legacy":
        path.write_text(json.dumps({"alsaInputDevice": "hw:0,0",
                                    "alsaSampleRate": 48000,
                                    "alsaFormat": "S24_3LE"}))
        s = cfg.load_config()
        s.alsa.channels = 2
        cfg.save_config(s)
    elif op == "inferred":
        path.write_text(json.dumps({"eqProfile": "myeq"}))
    elif op == "no_path":
        path.write_text(json.dumps({"eqEnabled": True}))
    elif op == "unknown_fields":
        path.write_text(json.dumps({"customField": 42}))
        cfg.save_config(cfg.Settings())
    elif op == "dither":
        cfg.save_config(cfg.Settings(alsa=cfg.AlsaSettings(
            format="S16_LE", dither=True)))
    elif op == "updates":
        cfg.save_config_updates({"filter": {"ratio": 16},
                                 "alsa": {"sampleRate": 44100}})
        cfg.save_config_updates({"alsa": {"channels": 2}})
    loaded = _plain(cfg.load_config())
    raw = cfg.load_raw_config()
    text = json.dumps([loaded, raw]).replace(str(root), "<root>")
    return json.loads(text)


@pytest.mark.parametrize("op", ["missing", "round_trip", "legacy", "inferred",
                                "no_path", "unknown_fields", "dither",
                                "updates"])
def test_config_service_equal(op, tmp_path, monkeypatch):
    out = []
    for pkg in PACKAGES:
        root = tmp_path / pkg
        root.mkdir()
        out.append(_config_ops(pkg, root, monkeypatch, op))
    assert out[0] == out[1]


def test_serve_stats_reader_equal(tmp_path, monkeypatch):
    stats = {"uptime_ms": 5, "streams": {"active": 1}}
    (tmp_path / "s.json").write_text(json.dumps(stats))
    monkeypatch.setenv("TOTTON_SERVE_STATS_PATH", str(tmp_path / "s.json"))
    got = [d.read_serve_stats_file() for d in _both("daemon")]
    monkeypatch.setenv("TOTTON_SERVE_STATS_PATH", str(tmp_path / "none"))
    got += [d.read_serve_stats_file() for d in _both("daemon")]
    assert got[0] == got[1] == stats and got[2] == got[3]


@pytest.mark.parametrize("env", [
    {}, {"TOTTON_RESTART_CMD": "true"},
    {"TOTTON_RESTART_CMD": "", "TOTTON_DOCKER_SOCKET": "/nonexistent.sock"},
])
def test_restart_strategy_equal(env, monkeypatch):
    """resolve_restart_fn picks the same strategy from the same
    environment (None, a command, or nothing without a Docker socket)."""
    out = []
    for restart in _both("restart"):
        fn = restart.resolve_restart_fn(
            env={"TOTTON_DOCKER_SOCKET": "/nonexistent.sock", **env})
        out.append(fn is None)
    assert out[0] == out[1]
