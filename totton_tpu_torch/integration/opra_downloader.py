"""OPRA database downloader with an injectable fetcher.

Parity with the reference's scripts/integration/opra_downloader.py:
resolve the latest pinned commit via the GitHub API, download the JSONL
from raw.githubusercontent.com (or a mirror), validate a sample of lines,
and sha256 the payload. The ``fetcher`` callable is injectable so tests run
network-free (the reference's FetchRecorder pattern).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable

DEFAULT_TIMEOUT_MS = int(os.environ.get("OPRA_DOWNLOAD_TIMEOUT_MS", "10000"))
DEFAULT_SAMPLE_LINES = int(os.environ.get("OPRA_VALIDATE_SAMPLE_LINES", "200"))

GITHUB_API_COMMITS = (
    "https://api.github.com/repos/opra-project/OPRA/commits?per_page=1"
)
GITHUB_RAW_TEMPLATE = (
    "https://raw.githubusercontent.com/opra-project/OPRA/{commit}/"
    "dist/database_v1.jsonl"
)
MIRROR_URL = os.environ.get("OPRA_MIRROR_URL", "")

Fetcher = Callable[[str, float], bytes]


class OpraDownloadError(Exception):
    pass


class OpraNetworkError(OpraDownloadError):
    pass


class OpraResponseError(OpraDownloadError):
    pass


class OpraValidationError(OpraDownloadError):
    pass


@dataclasses.dataclass
class OpraDownloadResult:
    commit_sha: str
    database_bytes: bytes
    sha256: str
    source_url: str
    entry_counts: dict


def _default_fetcher(url: str, timeout_sec: float) -> bytes:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, headers={"User-Agent": "totton-tpu-opra-sync"}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_sec) as resp:
            if resp.status != 200:
                raise OpraResponseError(f"HTTP {resp.status} for {url}")
            return resp.read()
    except urllib.error.URLError as e:
        raise OpraNetworkError(f"fetch failed for {url}: {e}") from e


def resolve_latest_commit_sha(
    fetcher: Fetcher | None = None, timeout_ms: int | None = None
) -> str:
    """Latest commit sha of the OPRA repo via the GitHub API."""
    fetcher = fetcher or _default_fetcher
    timeout = (timeout_ms or DEFAULT_TIMEOUT_MS) / 1000.0
    raw = fetcher(GITHUB_API_COMMITS, timeout)
    try:
        payload = json.loads(raw)
        sha = payload[0]["sha"]
    except (json.JSONDecodeError, KeyError, IndexError, TypeError) as e:
        raise OpraResponseError(f"unexpected commits API payload: {e}") from e
    return str(sha)


def validate_database(data: bytes, sample_lines: int = DEFAULT_SAMPLE_LINES) -> dict:
    """Parse a sample of JSONL lines; returns entry-type counts.

    Raises OpraValidationError when the payload is empty or contains no
    recognizable entries in the sample.
    """
    if not data.strip():
        raise OpraValidationError("empty database payload")
    counts = {"vendor": 0, "product": 0, "eq": 0, "other": 0, "bad": 0}
    for i, line in enumerate(data.splitlines()):
        if i >= sample_lines:
            break
        line = line.strip()
        if not line:
            continue
        try:
            entry = json.loads(line)
            t = entry.get("type")
            counts[t if t in counts else "other"] += 1
        except (json.JSONDecodeError, AttributeError):
            counts["bad"] += 1
    good = counts["vendor"] + counts["product"] + counts["eq"]
    if good == 0:
        raise OpraValidationError(
            f"no valid OPRA entries in the first {sample_lines} lines"
        )
    return counts


def download_opra_database(
    commit_sha: str | None = None,
    fetcher: Fetcher | None = None,
    timeout_ms: int | None = None,
    use_mirror: bool = False,
) -> OpraDownloadResult:
    """Download + validate the database at a pinned (or latest) commit."""
    fetcher = fetcher or _default_fetcher
    timeout = (timeout_ms or DEFAULT_TIMEOUT_MS) / 1000.0
    if commit_sha is None:
        commit_sha = resolve_latest_commit_sha(fetcher, timeout_ms)
    if use_mirror and MIRROR_URL:
        url = MIRROR_URL.format(commit=commit_sha)
    else:
        url = GITHUB_RAW_TEMPLATE.format(commit=commit_sha)
    data = fetcher(url, timeout)
    counts = validate_database(data)
    return OpraDownloadResult(
        commit_sha=commit_sha,
        database_bytes=data,
        sha256=hashlib.sha256(data).hexdigest(),
        source_url=url,
        entry_counts=counts,
    )
