"""Port parity: the web app (``totton_tpu_torch/web/``, copies of the JAX
package's) against the JAX package's app on the same requests.

Each case is a sequence of requests (the reference suites' cases:
tests/test_web.py, tests/test_web_ui.py) sent to the JAX app and to the
port's app, each with its own config and EQ directories, the OPRA fixture
database (tests/test_opra.py) and a dummy daemon client patched in (no
ZeroMQ daemon; tests/test_web.py's ``DummyClient``). The status codes,
the bodies (JSON parsed, pages as text) and every file each run wrote
must be equal, with each run's directory read as <root>. The UI's JS -> API contract and the
i18n catalog are checked on the port's files, and ``totton-web-torch``
serves the API from its own process."""

import importlib
import json
import re
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from tests.test_opra import SAMPLE_DB
from tests.test_web import DummyClient

pytest_plugins = "aiohttp.pytest_plugin"

torch = pytest.importorskip("torch")

PACKAGES = ("totton_tpu", "totton_tpu_torch")
PORT_WEB = Path(__file__).parent.parent / "totton_tpu_torch" / "web"
VALID_PROFILE = ("Preamp: -6 dB\n"
                 "Filter 1: ON PK Fc 1000 Hz Gain -3 dB Q 1.4\n")


def _upload(name: str, content: bytes):
    def make():
        import aiohttp

        form = aiohttp.FormData()
        form.add_field("file", content, filename=name)
        return form
    return make


#: name -> requests (method, path, options): "json" a body, "form" a
#: factory of a multipart body, "headers"; "write" (path, text) puts a
#: file under the run's directory first.
CASES = {
    "pages": [
        ("GET", "/", {}), ("GET", "/settings", {}), ("GET", "/opra-sync", {}),
        ("GET", "/?lang=ja", {}),
        ("GET", "/settings", {"headers": {"Accept-Language": "ja-JP,ja;q=0.9"}}),
        ("GET", "/settings", {"headers": {"Accept-Language": "fr-FR,fr;q=0.9"}}),
        ("GET", "/static/app.css", {}), ("GET", "/static/app.js", {}),
    ],
    "eq_import_activate_delete": [
        ("POST", "/api/eq/import-text",
         {"json": {"name": "myeq", "content": VALID_PROFILE}}),
        ("GET", "/api/eq/profiles", {}),
        ("POST", "/api/eq/activate/myeq", {}),
        ("GET", "/api/eq/active", {}),
        ("DELETE", "/api/eq/profiles/myeq", {}),
        ("POST", "/api/eq/deactivate", {}),
        ("DELETE", "/api/eq/profiles/myeq", {}),
        ("GET", "/eq/profiles", {}),
    ],
    "eq_invalid": [
        ("POST", "/api/eq/import-text",
         {"json": {"name": "bad", "content": "no preamp here"}}),
        ("POST", "/api/eq/import-text",
         {"json": {"name": "../evil", "content": VALID_PROFILE}}),
        ("POST", "/api/eq/activate/nothere", {}),
    ],
    "eq_upload": [
        ("POST", "/api/eq/validate",
         {"form": _upload("test.txt", VALID_PROFILE.encode())}),
        ("POST", "/api/eq/validate", {"form": _upload("evil.exe", b"x")}),
        ("POST", "/api/eq/import",
         {"form": _upload("up.txt", VALID_PROFILE.encode())}),
        ("GET", "/api/eq/profiles", {}),
    ],
    "opra_browse_apply": [
        ("GET", "/opra/stats", {}), ("GET", "/opra/vendors", {}),
        ("GET", "/opra/search?q=hd650", {}),
        ("GET", "/opra/product/p1", {}),
        ("GET", "/opra/eq/e1", {}), ("GET", "/opra/eq/e1?modern_target=1", {}),
        ("POST", "/opra/apply/e1?modern_target=1", {}),
        ("GET", "/api/eq/active", {}),
        ("POST", "/opra/apply/e2", {}),
        ("GET", "/api/eq/profiles", {}),
    ],
    "opra_missing": [
        ("GET", "/opra/product/zzz", {}), ("GET", "/opra/products/zzz", {}),
        ("GET", "/opra/eq/zzz", {}), ("GET", "/opra/search", {}),
        ("POST", "/opra/apply/zzz", {}),
    ],
    "opra_sync": [
        ("GET", "/api/opra/sync/status", {}),
        ("POST", "/api/opra/sync/rollback", {}),
    ],
    "daemon": [
        ("GET", "/api/status", {}), ("GET", "/api/daemon/phase-type", {}),
        ("PUT", "/api/daemon/phase-type", {"json": {"phase_type": "linear"}}),
        ("GET", "/api/status", {}),
        ("PUT", "/api/daemon/phase-type", {"json": {"phase_type": "warped"}}),
        ("POST", "/api/daemon/reload", {}),
        ("POST", "/api/daemon/soft-reset", {}),
        ("POST", "/api/daemon/restart", {}),
        ("GET", "/api/alsa/devices", {}),
    ],
    "config": [
        ("GET", "/api/config", {}),
        ("PATCH", "/api/config", {"json": {
            "filter": {"ratio": 16, "phaseType": "minimum"},
            "alsa": {"sampleRate": 44100}}}),
        ("PATCH", "/api/config", {"json": {"alsa": {"channels": 2}}}),
        ("PATCH", "/api/config", {"json": ["not", "an", "object"]}),
        ("GET", "/api/config", {}),
    ],
    "serve_stats": [
        ("write", "serve_stats.json", json.dumps({
            "uptime_ms": 1234,
            "streams": {"active": 3, "accepted": 7, "rejected": 0,
                        "finished": 4},
            "steps": 42, "frames_out": 100000, "per_stream": []})),
        ("GET", "/api/status", {}),
    ],
    "eq_response": [
        ("GET", "/api/eq/response", {}),
        ("write", "EQ/demo.txt", VALID_PROFILE),
        ("GET", "/api/eq/response?name=demo&points=64", {}),
        ("GET", "/api/eq/response?name=ghost", {}),
        ("GET", "/api/eq/response?name=../etc", {}),
        ("GET", "/api/eq/response?name=demo&sample_rate=1", {}),
        ("POST", "/api/eq/activate/demo", {}),
        ("GET", "/eq/response?points=16", {}),
    ],
}


def _setup(pkg, root, monkeypatch):
    """The environment and patches of one run; returns the app."""
    monkeypatch.setenv("TOTTON_CONFIG_PATH", str(root / "config.json"))
    monkeypatch.setenv("TOTTON_EQ_DIR", str(root / "EQ"))
    monkeypatch.setenv("TOTTON_STATS_PATH", str(root / "stats.json"))
    monkeypatch.setenv("TOTTON_SERVE_STATS_PATH",
                       str(root / "serve_stats.json"))
    db = root.parent / f"{root.name}_opra.jsonl"
    db.write_text(SAMPLE_DB)
    monkeypatch.setenv("OPRA_DATABASE_PATH", str(db))
    importlib.import_module(f"{pkg}.integration.opra").reset_database_cache()
    # The dummy's phase is class state: each run starts from minimum.
    monkeypatch.setattr(DummyClient, "phase", "minimum")
    monkeypatch.setattr(
        importlib.import_module(f"{pkg}.web.services.daemon"), "get_client",
        lambda timeout_ms=1000: DummyClient())
    sync = importlib.import_module(f"{pkg}.integration.opra_sync")
    cache = importlib.import_module(f"{pkg}.integration.opra_cache")
    app = importlib.import_module(f"{pkg}.web.app")
    return app.create_app(opra_sync=sync.OpraSyncService(
        cache.OpraCacheManager(root.parent / f"{root.name}_cache")))


def _files(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): p.read_text()
            for p in sorted(root.rglob("*")) if p.is_file()}


async def _run(pkg, root, steps, monkeypatch, aiohttp_client):
    root.mkdir()
    client = await aiohttp_client(_setup(pkg, root, monkeypatch))
    replies = []
    for method, path, opts in steps:
        if method == "write":
            (root / path).parent.mkdir(parents=True, exist_ok=True)
            (root / path).write_text(opts)
            continue
        kw = {k: v for k, v in opts.items() if k in ("json", "headers")}
        if "form" in opts:
            kw["data"] = opts["form"]()
        resp = await client.request(method, path, **kw)
        body = await resp.text()
        if resp.content_type == "application/json":
            body = json.loads(body)
        replies.append((method, path, resp.status, body))
    out = json.dumps({"replies": replies, "files": _files(root)},
                     sort_keys=True, ensure_ascii=False)
    return json.loads(out.replace(str(root), "<root>")), replies


@pytest.mark.parametrize("case", sorted(CASES))
async def test_port_app_answers_as_the_reference(case, tmp_path, monkeypatch,
                                                 aiohttp_client):
    ref, _ = await _run("totton_tpu", tmp_path / "ref", CASES[case],
                        monkeypatch, aiohttp_client)
    port, replies = await _run("totton_tpu_torch", tmp_path / "port",
                               CASES[case], monkeypatch, aiohttp_client)
    assert port == ref
    # Not vacuous: the reference suites' expectations hold too.
    statuses = [r[2] for r in replies]
    expect = {
        "eq_import_activate_delete": [200, 200, 200, 200, 409, 200, 200, 200],
        "eq_invalid": [400, 400, 404],
        "opra_missing": [404, 404, 404, 400, 404],
        "daemon": [200, 200, 200, 200, 400, 200, 200, 501, 200],
    }
    if case in expect:
        assert statuses == expect[case]
    if case == "opra_browse_apply":
        assert port["files"]["EQ/opra_e1_kb5000_7.txt"].startswith("# OPRA:")
        assert replies[7][3]["active"] == "opra_e1_kb5000_7"
    if case == "config":
        cfg = json.loads(port["files"]["config.json"])
        assert cfg["alsa"] == {"sampleRate": 44100, "channels": 2}


# ----------------------------------------------------- JS -> API contract

_URL_RE = re.compile(r"""['"`](/(?:api|opra)[^'"`\s?]*)""")
_T_KEY_RE = re.compile(r"""\bt\(\s*['"]([a-z0-9_.]+)['"]\s*\)""")
_TR_KEY_RE = re.compile(r"""\btr\(\s*['"]([a-z0-9_.]+)['"]\s*\)""")


def _ui_files():
    return (sorted((PORT_WEB / "templates").glob("*.html"))
            + sorted((PORT_WEB / "static").glob("*.js")))


def test_every_fetched_url_is_a_registered_route():
    """The port's pages call only routes the port's app registers."""
    from totton_tpu_torch.web.app import create_app

    patterns = [re.compile("^" + re.sub(r"\{[^}]+\}", r"[^/]+",
                                        res.canonical) + "$")
                for res in create_app().router.resources()]
    fetched = {(f.name, re.sub(r"\$\{[^}]*\}", "dynamic", m.group(1)))
               for f in _ui_files() for m in _URL_RE.finditer(f.read_text())}
    assert fetched
    assert [x for x in fetched
            if not any(p.match(x[1]) for p in patterns)] == []


def test_routes_equal_the_reference():
    routes = []
    for pkg in PACKAGES:
        app = importlib.import_module(f"{pkg}.web.app").create_app()
        routes.append(sorted((r.method, r.resource.canonical)
                             for r in app.router.routes()))
    assert routes[0] == routes[1]


def test_i18n_catalogs_equal_the_reference_and_cover_the_templates():
    from totton_tpu.web import i18n as ref_i18n
    from totton_tpu_torch.web import i18n

    assert i18n.TRANSLATIONS == ref_i18n.TRANSLATIONS
    for locale in i18n.TRANSLATIONS:
        assert i18n.js_catalog(locale) == ref_i18n.js_catalog(locale)
    used = set()
    for f in _ui_files():
        used.update(_TR_KEY_RE.findall(f.read_text()))
        if f.suffix == ".html":
            used.update(_T_KEY_RE.findall(f.read_text()))
    assert used and not used - set(i18n.TRANSLATIONS["en"])
    en = set(i18n.TRANSLATIONS["en"])
    assert all(set(t) == en for t in i18n.TRANSLATIONS.values())


@pytest.mark.parametrize("query,headers,want", [
    (None, None, "en"), ({"lang": "ja"}, None, "ja"),
    ({"lang": "xx"}, None, "en"),
    (None, {"Accept-Language": "ja;q=0.8, en;q=0.5"}, "ja"),
    (None, {"Accept-Language": "fr-FR,fr;q=0.9"}, "en"),
])
def test_negotiate_locale_equal(query, headers, want):
    class Req:
        def __init__(self):
            self.query = query or {}
            self.headers = headers or {}

    got = [importlib.import_module(f"{pkg}.web.i18n").negotiate_locale(
        None if query is None and headers is None else Req())
        for pkg in PACKAGES]
    assert got == [want, want]


# ------------------------------------------------------------ the CLI

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_webserver_cli_serves_api(tmp_path):
    """``python -m totton_tpu_torch.cli.webserver`` answers /api/status
    and renders the dashboard, without loading jax."""
    port = _free_port()
    env = {k: v for k, v in __import__("os").environ.items()
           if k != "TOTTON_PLATFORM"}
    env.update(TOTTON_CONFIG_PATH=str(tmp_path / "config.json"),
               TOTTON_EQ_DIR=str(tmp_path / "EQ"),
               TOTTON_DATA_DIR=str(tmp_path / "data"),
               TOTTON_ZMQ_ENDPOINT=f"ipc://{tmp_path}/none.sock")
    code = ("import runpy, sys; sys.argv = ['totton-web-torch', '--host', "
            f"'127.0.0.1', '--port', '{port}'];\n"
            "import atexit; atexit.register(lambda: print('JAX', 'jax' in "
            "sys.modules, flush=True))\n"
            "runpy.run_module('totton_tpu_torch.cli.webserver', "
            "run_name='__main__')")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        deadline = time.monotonic() + 30
        body = None
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/api/status", timeout=2) as r:
                    body = json.load(r)
                break
            except OSError:
                if proc.poll() is not None:
                    raise AssertionError(
                        f"totton-web-torch exited early: {proc.stdout.read()}")
                time.sleep(0.2)
        assert body is not None, "web server never answered /api/status"
        assert body["daemon_running"] is False
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=5) as r:
            assert r.status == 200
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=10)
    assert "JAX False" in out
