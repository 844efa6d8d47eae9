"""Port parity: the OPRA integration (``totton_tpu_torch/integration/``,
copies of the JAX package's modules) against the JAX package's on the
same inputs: the database reader, OPRA -> APO conversion and the modern
target, the versioned cache, the downloader and the sync service. Every
fetch goes to a stub fetcher (tests/test_opra.py's), never the network.
Timestamps and each run's directory are normalised before comparing."""

import dataclasses
import importlib
import json
import re

import pytest

from tests.test_opra import SAMPLE_DB, FetchRecorder

torch = pytest.importorskip("torch")

PACKAGES = ("totton_tpu", "totton_tpu_torch")
_ISO_TIME = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?\+00:00")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.integration.{name}")


def _plain(value, root=None):
    """JSON-comparable form: dataclasses as dicts, paths as strings, the
    run's directory as <root>, ISO timestamps as <time>."""
    if dataclasses.is_dataclass(value):
        value = dataclasses.asdict(value)
    text = json.dumps(value, default=str, sort_keys=True)
    if root is not None:
        text = text.replace(str(root), "<root>")
    return json.loads(_ISO_TIME.sub("<time>", text))


def _both(tmp_path, fn):
    """fn(pkg, root) for each package, each with a directory of its own;
    returns the two results, normalised."""
    out = []
    for pkg in PACKAGES:
        root = tmp_path / pkg
        root.mkdir()
        out.append(_plain(fn(pkg, root), root))
    return out


def _db(pkg, root):
    path = root / "database_v1.jsonl"
    path.write_text(SAMPLE_DB)
    return _mod(pkg, "opra").OpraDatabase(path)


@pytest.mark.parametrize("query", [
    ("counts", None), ("vendors", None), ("search", "hd650"),
    ("search", "akg"), ("search", ""), ("search", "NoEq"),
    ("product", "p1"), ("product", "zzz"), ("eq", "e1"), ("eq", "nope"),
])
def test_database_queries_equal(tmp_path, query):
    kind, arg = query

    def run(pkg, root):
        db = _db(pkg, root)
        if kind == "counts":
            return [db.vendor_count, db.product_count, db.eq_profile_count]
        if kind == "vendors":
            return db.get_vendors()
        if kind == "search":
            return db.search(arg)
        if kind == "product":
            return db.get_product(arg)
        return db.get_eq_profile(arg)

    a, b = _both(tmp_path, run)
    assert a == b


def test_missing_database_raises_in_both(tmp_path):
    for pkg in PACKAGES:
        with pytest.raises(FileNotFoundError, match="OPRA database"):
            _mod(pkg, "opra").OpraDatabase(tmp_path / "none.jsonl").vendor_count


@pytest.mark.parametrize("eq_id", ["e1", "e2"])
@pytest.mark.parametrize("modern_target", [False, True])
def test_conversion_and_apo_text_equal(tmp_path, eq_id, modern_target):
    def run(pkg, root):
        opra = _mod(pkg, "opra")
        apo = opra.convert_opra_to_apo(_db(pkg, root).get_eq_profile(eq_id))
        if modern_target:
            apo = opra.apply_modern_target_correction(apo)
        return [apo, apo.to_apo_format()]

    a, b = _both(tmp_path, run)
    assert a == b


def test_band_conversion_and_slope_table_equal(tmp_path):
    bands = [{"type": "band_pass"}, {"type": "peak_dip", "frequency": 200,
                                     "gain_db": -2.0, "q": 0.6},
             {"type": "high_pass", "frequency": 20, "slope": 24}]

    def run(pkg, root):
        opra = _mod(pkg, "opra")
        return ([opra.convert_opra_band(b) for b in bands]
                + [opra.slope_to_q(s) for s in (6, 12, 18, 24, 36, 99)])

    a, b = _both(tmp_path, run)
    assert a == b


def test_modern_target_spec_equal(tmp_path):
    a, b = _both(tmp_path, lambda pkg, root: importlib.import_module(
        f"{pkg}.integration").MODERN_TARGET_SPEC)
    assert a == b


def _cache_lifecycle(pkg, root):
    cache = _mod(pkg, "opra_cache")
    mgr = cache.OpraCacheManager(root)
    out = [cache.normalize_commit_sha("ABCDEF1")]
    for sha, body in (("a" * 40, b"one"), ("b" * 40, b"two"),
                      ("c" * 40, b"three")):
        mgr.install_version(sha, body)
        mgr.activate_version(sha)
        out.append([mgr.get_current_commit(), mgr.list_versions()])
    out.append(mgr.rollback())
    out.append(mgr.load_state())
    out.append(sorted(mgr.prune_versions(keep=2)))
    out.append(sorted(mgr.list_versions()))
    out.append(cache.compute_sha256(mgr.current_path / "database_v1.jsonl"))
    out.append(json.loads((mgr.current_path / "metadata.json").read_text()))
    return out


def test_cache_lifecycle_equal(tmp_path):
    a, b = _both(tmp_path, _cache_lifecycle)
    assert a == b


def test_cache_refusals_equal(tmp_path):
    for pkg in PACKAGES:
        cache = _mod(pkg, "opra_cache")
        with pytest.raises(ValueError):
            cache.normalize_commit_sha("../escape")
        with pytest.raises(RuntimeError, match="no previous"):
            cache.OpraCacheManager(tmp_path / pkg).rollback()


def test_downloader_with_stub_fetcher_equal(tmp_path):
    def run(pkg, root):
        dl = _mod(pkg, "opra_downloader")
        latest = FetchRecorder(
            {"api.github.com": json.dumps([{"sha": "c" * 40}]).encode()})
        raw = FetchRecorder({"raw.githubusercontent.com": SAMPLE_DB.encode()})
        result = dl.download_opra_database("d" * 40, raw)
        return [dl.resolve_latest_commit_sha(latest), result, latest.calls,
                raw.calls]

    a, b = _both(tmp_path, run)
    assert a == b


@pytest.mark.parametrize("body", [b"not\njson\nlines", b"   "])
def test_validation_rejects_garbage_in_both(body):
    for pkg in PACKAGES:
        dl = _mod(pkg, "opra_downloader")
        with pytest.raises(dl.OpraValidationError):
            dl.validate_database(body)


def test_network_error_propagates_in_both():
    for pkg in PACKAGES:
        dl = _mod(pkg, "opra_downloader")
        fetcher = FetchRecorder({"raw": dl.OpraNetworkError("boom")})
        with pytest.raises(dl.OpraNetworkError):
            dl.download_opra_database("e" * 40, fetcher)


def test_sync_update_rollback_and_failure_equal(tmp_path):
    def run(pkg, root):
        svc = _mod(pkg, "opra_sync").OpraSyncService(
            _mod(pkg, "opra_cache").OpraCacheManager(root))
        ok = FetchRecorder({"raw.githubusercontent.com": SAMPLE_DB.encode()})
        out = [svc.update("1" * 40, ok), svc.update("2" * 40, ok)]
        db = _mod(pkg, "opra").OpraDatabase(
            svc.cache.current_path / "database_v1.jsonl")
        out += [db.product_count, svc.rollback()]
        down = FetchRecorder(
            {"raw": _mod(pkg, "opra_downloader").OpraNetworkError("down")})
        with pytest.raises(_mod(pkg, "opra_downloader").OpraNetworkError):
            svc.update("3" * 40, down)
        out.append(svc.status())
        return out

    a, b = _both(tmp_path, run)
    assert a == b
    assert a[-1]["status"] == "error"


def test_concurrent_update_rejected_in_both(tmp_path):
    for pkg in PACKAGES:
        sync = _mod(pkg, "opra_sync")
        svc = sync.OpraSyncService(
            _mod(pkg, "opra_cache").OpraCacheManager(tmp_path / pkg))
        svc._lock.acquire()
        try:
            with pytest.raises(sync.SyncInProgressError):
                svc.update("a" * 40, lambda u, t: b"")
        finally:
            svc._lock.release()


def test_get_database_reads_the_environment(tmp_path, monkeypatch):
    """get_database() follows OPRA_DATABASE_PATH in both packages."""
    path = tmp_path / "db.jsonl"
    path.write_text(SAMPLE_DB)
    monkeypatch.setenv("OPRA_DATABASE_PATH", str(path))
    counts = []
    for pkg in PACKAGES:
        opra = _mod(pkg, "opra")
        opra.reset_database_cache()
        counts.append(opra.get_database().product_count)
        opra.reset_database_cache()
    assert counts == [3, 3]
