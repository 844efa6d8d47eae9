"""OPRA sync orchestration: check / update / rollback jobs.

Parity with the reference's web/services/opra_sync.py: a lock guards
concurrent jobs; update downloads (pinned or latest commit), installs into
the versioned cache, activates, prunes, and records status; rollback swaps
back to the previous version. All network goes through the injectable
fetcher so tests run offline.
"""

from __future__ import annotations

import threading

from totton_tpu_torch.integration.opra import reset_database_cache
from totton_tpu_torch.integration.opra_cache import OpraCacheManager
from totton_tpu_torch.integration.opra_downloader import (
    Fetcher,
    OpraDownloadError,
    download_opra_database,
    resolve_latest_commit_sha,
)


class SyncInProgressError(RuntimeError):
    pass


class OpraSyncService:
    def __init__(self, cache: OpraCacheManager | None = None) -> None:
        self.cache = cache or OpraCacheManager()
        self._lock = threading.Lock()

    def status(self) -> dict:
        state = self.cache.load_state()
        return {
            "status": state.status,
            "message": state.message,
            "current_commit": state.current_commit,
            "previous_commit": state.previous_commit,
            "last_update": state.last_update,
            "installed_versions": self.cache.list_versions(),
            "in_progress": self._lock.locked(),
        }

    def check_available(self, fetcher: Fetcher | None = None) -> dict:
        """Latest upstream commit vs the active one."""
        latest = resolve_latest_commit_sha(fetcher)
        current = self.cache.get_current_commit()
        return {
            "latest_commit": latest,
            "current_commit": current,
            "update_available": current is None or not latest.startswith(current),
        }

    def update(
        self,
        commit_sha: str | None = None,
        fetcher: Fetcher | None = None,
    ) -> dict:
        """Download/install/activate. Raises SyncInProgressError if a job is
        already running; returns the new status dict."""
        if not self._lock.acquire(blocking=False):
            raise SyncInProgressError("OPRA sync already in progress")
        try:
            self.cache.set_status("syncing", "downloading database")
            try:
                result = download_opra_database(commit_sha, fetcher)
                self.cache.install_version(
                    result.commit_sha,
                    result.database_bytes,
                    metadata={
                        "source_url": result.source_url,
                        "entry_counts": result.entry_counts,
                    },
                )
                self.cache.activate_version(result.commit_sha)
                self.cache.prune_versions()
                self.cache.set_status(
                    "success", f"installed {result.commit_sha[:12]}"
                )
                reset_database_cache()
            except (OpraDownloadError, OSError, ValueError) as e:
                self.cache.set_status("error", str(e))
                raise
        finally:
            self._lock.release()
        return self.status()

    def rollback(self) -> dict:
        if not self._lock.acquire(blocking=False):
            raise SyncInProgressError("OPRA sync already in progress")
        try:
            self.cache.rollback()
            reset_database_cache()
        finally:
            self._lock.release()
        return self.status()
