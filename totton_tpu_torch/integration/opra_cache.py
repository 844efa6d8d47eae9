"""Versioned OPRA cache with atomic install, rollback, and pruning.

Parity with the reference's scripts/integration/opra_cache.py: layout

  <data_dir>/opra/
    versions/<sha>/database_v1.jsonl + metadata.json
    current -> versions/<sha>        (atomic symlink swap)
    opra_sync_state.json             (status/history)

Install stages into a tmp dir then os.replace (atomic on one filesystem);
activation swaps the `current` symlink atomically; rollback re-activates the
previously-activated version; prune keeps the newest KEEP_VERSIONS.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import os
import re
import shutil
import tempfile
from pathlib import Path
from typing import Any

DATABASE_FILENAME = "database_v1.jsonl"
METADATA_FILENAME = "metadata.json"
STATE_FILENAME = "opra_sync_state.json"
KEEP_VERSIONS = 3

_SAFE_SHA = re.compile(r"^[0-9a-f]{7,64}$")


def _now_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def _default_data_dir() -> Path:
    return Path(os.environ.get("TOTTON_DATA_DIR", "/var/lib/gpu_upsampler"))


def normalize_commit_sha(commit_sha: str | None) -> str:
    """Lowercased validated sha; raises on anything path-unsafe."""
    sha = (commit_sha or "").strip().lower()
    if not _SAFE_SHA.match(sha):
        raise ValueError(f"invalid commit sha: {commit_sha!r}")
    return sha


def compute_sha256(path: Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


@dataclasses.dataclass
class OpraSyncState:
    status: str = "idle"  # idle | syncing | success | error | rolled_back
    message: str = ""
    current_commit: str | None = None
    previous_commit: str | None = None
    last_update: str | None = None
    history: list[dict] = dataclasses.field(default_factory=list)

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "OpraSyncState":
        return cls(
            status=data.get("status", "idle"),
            message=data.get("message", ""),
            current_commit=data.get("current_commit"),
            previous_commit=data.get("previous_commit"),
            last_update=data.get("last_update"),
            history=list(data.get("history", [])),
        )

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


class OpraCacheManager:
    def __init__(self, data_dir: Path | str | None = None) -> None:
        base = Path(data_dir) if data_dir else _default_data_dir()
        self.opra_dir = base / "opra"

    # -- layout -----------------------------------------------------------

    @property
    def versions_dir(self) -> Path:
        return self.opra_dir / "versions"

    @property
    def current_path(self) -> Path:
        return self.opra_dir / "current"

    @property
    def state_path(self) -> Path:
        return self.opra_dir / STATE_FILENAME

    def ensure_layout(self) -> None:
        self.versions_dir.mkdir(parents=True, exist_ok=True)

    # -- install / activate ----------------------------------------------

    def install_version(
        self,
        commit_sha: str,
        database_bytes: bytes,
        metadata: dict | None = None,
    ) -> Path:
        """Stage the database into versions/<sha> atomically. Returns the
        version dir. Re-installing an existing version replaces it."""
        sha = normalize_commit_sha(commit_sha)
        self.ensure_layout()
        dest = self.versions_dir / sha
        tmp = Path(
            tempfile.mkdtemp(prefix=f".install-{sha}-", dir=self.versions_dir)
        )
        try:
            (tmp / DATABASE_FILENAME).write_bytes(database_bytes)
            meta = {
                "commit_sha": sha,
                "installed_at": _now_iso(),
                "sha256": hashlib.sha256(database_bytes).hexdigest(),
                "size_bytes": len(database_bytes),
            }
            meta.update(metadata or {})
            (tmp / METADATA_FILENAME).write_text(json.dumps(meta, indent=2))
            if dest.exists():
                shutil.rmtree(dest)
            os.replace(tmp, dest)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return dest

    def get_current_commit(self) -> str | None:
        try:
            target = os.readlink(self.current_path)
        except OSError:
            return None
        return Path(target).name

    def activate_version(self, commit_sha: str) -> None:
        """Atomically swap the `current` symlink to versions/<sha>."""
        sha = normalize_commit_sha(commit_sha)
        dest = self.versions_dir / sha
        if not dest.is_dir():
            raise FileNotFoundError(f"version not installed: {sha}")
        previous = self.get_current_commit()
        tmp_link = self.opra_dir / f".current-{sha}.tmp"
        try:
            tmp_link.unlink()
        except OSError:
            pass
        os.symlink(os.path.join("versions", sha), tmp_link)
        os.replace(tmp_link, self.current_path)

        state = self.load_state()
        if previous and previous != sha:
            state.previous_commit = previous
        state.current_commit = sha
        state.last_update = _now_iso()
        state.history.append({"commit": sha, "activated_at": _now_iso()})
        state.history = state.history[-20:]
        self.save_state(state)

    def rollback(self) -> str:
        """Re-activate the previously-activated version. Returns its sha."""
        state = self.load_state()
        prev = state.previous_commit
        if not prev:
            raise RuntimeError("no previous version to roll back to")
        if not (self.versions_dir / prev).is_dir():
            raise FileNotFoundError(f"previous version missing: {prev}")
        self.activate_version(prev)
        state = self.load_state()
        state.status = "rolled_back"
        state.message = f"rolled back to {prev}"
        self.save_state(state)
        return prev

    # -- state ------------------------------------------------------------

    def load_state(self) -> OpraSyncState:
        try:
            return OpraSyncState.from_dict(
                json.loads(self.state_path.read_text())
            )
        except (OSError, json.JSONDecodeError, ValueError):
            return OpraSyncState()

    def save_state(self, state: OpraSyncState) -> None:
        self.ensure_layout()
        tmp = self.state_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(state.to_dict(), indent=2))
        os.replace(tmp, self.state_path)

    def set_status(self, status: str, message: str = "") -> None:
        state = self.load_state()
        state.status = status
        state.message = message
        self.save_state(state)

    # -- pruning ----------------------------------------------------------

    def list_versions(self) -> list[str]:
        if not self.versions_dir.is_dir():
            return []
        return sorted(
            p.name for p in self.versions_dir.iterdir()
            if p.is_dir() and not p.name.startswith(".")
        )

    def prune_versions(self, keep: int = KEEP_VERSIONS) -> list[str]:
        """Remove all but the `keep` most-recent versions (by mtime),
        never removing the current or previous one. Returns removed shas."""
        state = self.load_state()
        protected = {state.current_commit, state.previous_commit}
        dirs = [
            p for p in (self.versions_dir.iterdir()
                        if self.versions_dir.is_dir() else [])
            if p.is_dir() and not p.name.startswith(".")
        ]
        dirs.sort(key=lambda p: p.stat().st_mtime, reverse=True)
        removed = []
        for p in dirs[keep:]:
            if p.name in protected:
                continue
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p.name)
        return removed
