"""OPRA headphone EQ database reader and OPRA->APO conversion.

Parity with the reference's scripts/integration/opra.py: lazy JSONL loader
(vendor/product/eq entry types), relevance-sorted search, band-type mapping
(peak_dip/low_shelf/high_shelf/low_pass/high_pass -> PK/LS/HS/LP/HP;
band_pass/band_stop unsupported), LP/HP slope->Q table, and runtime
Modern-Target correction (KB5000_7 band appended, preamp reduced by its
gain — applied at runtime to comply with CC BY-SA 4.0).

Database path resolution: OPRA_DATABASE_PATH env override, else the synced
cache's current version (totton_tpu_torch.integration.opra_cache).
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

from totton_tpu_torch.integration.modern_target import MODERN_TARGET_CORRECTION_BAND

DATABASE_FILENAME = "database_v1.jsonl"

#: Butterworth-ish slope (dB/oct) -> single-biquad Q approximation.
_SLOPE_Q = {6: 0.5, 12: 0.707, 18: 0.5, 24: 0.541, 30: 0.5, 36: 0.518}

_TYPE_MAP = {
    "peak_dip": "PK",
    "low_shelf": "LS",
    "high_shelf": "HS",
    "low_pass": "LP",
    "high_pass": "HP",
}


@dataclasses.dataclass
class ApoBand:
    enabled: bool = True
    filter_type: str = "PK"
    frequency: float = 1000.0
    gain_db: float = 0.0
    q: float = 1.0


@dataclasses.dataclass
class ApoProfile:
    """EQ profile in Equalizer-APO terms, with CC BY-SA attribution."""

    name: str = ""
    preamp_db: float = 0.0
    bands: list[ApoBand] = dataclasses.field(default_factory=list)
    author: str = ""
    source: str = "OPRA"
    details: str = ""

    def to_apo_format(self) -> str:
        lines = []
        if self.preamp_db != 0.0:
            lines.append(f"Preamp: {self.preamp_db:.1f} dB")
        num = 0
        for band in self.bands:
            if not band.enabled:
                continue
            num += 1
            if band.filter_type in ("LP", "HP"):
                lines.append(
                    f"Filter {num}: ON {band.filter_type} "
                    f"Fc {band.frequency:.1f} Hz Q {band.q:.2f}"
                )
            else:
                lines.append(
                    f"Filter {num}: ON {band.filter_type} "
                    f"Fc {band.frequency:.1f} Hz Gain {band.gain_db:.1f} dB "
                    f"Q {band.q:.2f}"
                )
        return "\n".join(lines)


def slope_to_q(slope_db_per_oct: int) -> float:
    return _SLOPE_Q.get(slope_db_per_oct, 0.707)


def convert_opra_band(band_data: dict) -> ApoBand | None:
    """One OPRA band -> APO band, or None for unsupported types."""
    apo_type = _TYPE_MAP.get(band_data.get("type", ""))
    if apo_type is None:
        return None
    frequency = band_data.get("frequency", 1000.0)
    gain_db = band_data.get("gain_db", 0.0)
    q = band_data.get("q")
    if apo_type in ("LP", "HP"):
        slope = band_data.get("slope")
        q = slope_to_q(slope) if slope is not None else 0.707
        gain_db = 0.0
    elif q is None:
        q = 1.0
    return ApoBand(filter_type=apo_type, frequency=frequency,
                   gain_db=gain_db, q=q)


def convert_opra_to_apo(eq_data: dict) -> ApoProfile:
    """OPRA eq entry (with 'parameters'/'author'/'details') -> ApoProfile."""
    params = eq_data.get("parameters", {})
    bands = [
        b for b in (convert_opra_band(bd) for bd in params.get("bands", []))
        if b is not None
    ]
    return ApoProfile(
        name=eq_data.get("name", ""),
        preamp_db=params.get("gain_db", 0.0),
        bands=bands,
        author=eq_data.get("author", ""),
        details=eq_data.get("details", ""),
    )


def apply_modern_target_correction(profile: ApoProfile) -> ApoProfile:
    """Append the KB5000_7 correction band; reduce preamp by its gain to
    prevent clipping."""
    c = MODERN_TARGET_CORRECTION_BAND
    band = ApoBand(filter_type=c.filter_type, frequency=c.frequency,
                   gain_db=c.gain_db, q=c.q)
    suffix = "Modern Target (KB5000_7)"
    return ApoProfile(
        name=profile.name,
        preamp_db=profile.preamp_db - c.gain_db,
        bands=profile.bands + [band],
        author=profile.author,
        source=profile.source,
        details=f"{profile.details} + {suffix}" if profile.details else suffix,
    )


def _resolve_default_path() -> Path:
    env = os.environ.get("OPRA_DATABASE_PATH")
    if env:
        return Path(env).expanduser()
    from totton_tpu_torch.integration.opra_cache import OpraCacheManager

    return OpraCacheManager().current_path / DATABASE_FILENAME


class OpraDatabase:
    """Lazy JSONL reader over vendor/product/eq entries."""

    def __init__(self, db_path: Path | str | None = None) -> None:
        self.db_path = Path(db_path) if db_path else None
        self._vendors: dict[str, dict] = {}
        self._products: dict[str, dict] = {}
        self._eq_profiles: dict[str, dict] = {}
        self._loaded = False

    def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        path = self.db_path or _resolve_default_path()
        if not path.exists():
            raise FileNotFoundError(
                f"OPRA database not found at {path}. Run OPRA sync to install "
                "the cache, or set OPRA_DATABASE_PATH to a fixture."
            )
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except json.JSONDecodeError:
                    continue
                bucket = {
                    "vendor": self._vendors,
                    "product": self._products,
                    "eq": self._eq_profiles,
                }.get(entry.get("type"))
                if bucket is not None:
                    bucket[entry.get("id")] = entry.get("data", {})
        self._loaded = True

    # -- stats ------------------------------------------------------------

    @property
    def vendor_count(self) -> int:
        self._ensure_loaded()
        return len(self._vendors)

    @property
    def product_count(self) -> int:
        self._ensure_loaded()
        return len(self._products)

    @property
    def eq_profile_count(self) -> int:
        self._ensure_loaded()
        return len(self._eq_profiles)

    # -- queries ----------------------------------------------------------

    def get_vendors(self) -> list[dict]:
        self._ensure_loaded()
        vendors = [{"id": vid, **vd} for vid, vd in self._vendors.items()]
        vendors.sort(key=lambda v: v.get("name", "").lower())
        return vendors

    def _profiles_for_product(self, product_id: str) -> list[dict]:
        return [
            {"id": eq_id, **eq}
            for eq_id, eq in self._eq_profiles.items()
            if eq.get("product_id") == product_id
        ]

    def get_products_by_vendor(self, vendor_id: str) -> list[dict]:
        self._ensure_loaded()
        products = [
            {"id": pid, "eq_profiles": self._profiles_for_product(pid), **pd}
            for pid, pd in self._products.items()
            if pd.get("vendor_id") == vendor_id
        ]
        products.sort(key=lambda p: p.get("name", "").lower())
        return products

    def search(self, query: str, limit: int = 50) -> list[dict]:
        """Case-insensitive product/vendor-name search, relevance sorted
        (exact match, then prefix, then vendor/name); only products that
        have EQ profiles."""
        self._ensure_loaded()
        q = query.lower()
        results = []
        for pid, pd in self._products.items():
            name = pd.get("name", "")
            vendor = self._vendors.get(pd.get("vendor_id", ""), {})
            vendor_name = vendor.get("name", "")
            if q in name.lower() or q in vendor_name.lower():
                profiles = self._profiles_for_product(pid)
                if profiles:
                    results.append({
                        "id": pid,
                        "name": name,
                        "type": pd.get("type", ""),
                        "vendor": {"id": pd.get("vendor_id", ""),
                                   "name": vendor_name},
                        "eq_profiles": profiles,
                    })

        def sort_key(item):
            name = item["name"].lower()
            vendor = item["vendor"]["name"].lower()
            return (
                q != name,
                not (name.startswith(q) or vendor.startswith(q)),
                vendor,
                name,
            )

        results.sort(key=sort_key)
        return results[:limit]

    def get_eq_profile(self, eq_id: str) -> dict | None:
        self._ensure_loaded()
        eq = self._eq_profiles.get(eq_id)
        return None if eq is None else {"id": eq_id, **eq}

    def get_product(self, product_id: str) -> dict | None:
        self._ensure_loaded()
        pd = self._products.get(product_id)
        if pd is None:
            return None
        vendor = self._vendors.get(pd.get("vendor_id", ""), {})
        return {
            "id": product_id,
            "name": pd.get("name", ""),
            "type": pd.get("type", ""),
            "vendor": {"id": pd.get("vendor_id", ""),
                       "name": vendor.get("name", "")},
            "eq_profiles": self._profiles_for_product(product_id),
        }


_db_instance: OpraDatabase | None = None


def get_database() -> OpraDatabase:
    global _db_instance
    if _db_instance is None:
        _db_instance = OpraDatabase()
    return _db_instance


def reset_database_cache() -> None:
    """Drop the singleton (after a sync installs a new version)."""
    global _db_instance
    _db_instance = None
