"""config.json load/save.

Schema parity with the reference (web/services/config.py, example at
release/config.example.json): camelCase keys

  { "eqEnabled": bool, "eqProfile": str|null, "eqProfilePath": str|null,
    "alsa": {inputDevice, outputDevice, sampleRate, channels, format,
             periodFrames, bufferFrames},
    "filter": {ratio, phaseType, directory} }

with migration from legacy flat keys (alsaInputDevice, ...) on load; save
preserves unknown fields and strips migrated legacy keys.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

from totton_tpu_torch.web.constants import config_path, eq_profiles_dir

_LEGACY_ALSA_KEYS = {
    "alsaInputDevice": "inputDevice",
    "alsaOutputDevice": "outputDevice",
    "alsaSampleRate": "sampleRate",
    "alsaChannels": "channels",
    "alsaFormat": "format",
}


@dataclasses.dataclass
class AlsaSettings:
    input_device: str | None = None
    output_device: str | None = None
    sample_rate: int | None = None
    channels: int | None = None
    format: str | None = None
    period_frames: int | None = None
    buffer_frames: int | None = None
    dither: bool | None = None


@dataclasses.dataclass
class FilterSettings:
    ratio: int | None = None
    phase_type: str | None = None
    directory: str | None = None


@dataclasses.dataclass
class Settings:
    eq_enabled: bool = False
    eq_profile: str | None = None
    eq_profile_path: str | None = None
    alsa: AlsaSettings | None = None
    filter: FilterSettings | None = None


def _profile_path_for(name: str | None) -> str | None:
    if not name:
        return None
    return str(eq_profiles_dir() / f"{name}.txt")


def load_raw_config(path: Path | None = None) -> dict[str, Any]:
    path = path or config_path()
    try:
        data = json.loads(path.read_text())
        return data if isinstance(data, dict) else {}
    except (OSError, json.JSONDecodeError):
        return {}


def load_config(path: Path | None = None) -> Settings:
    data = load_raw_config(path)
    if not data:
        return Settings()

    alsa_block = data.get("alsa") if isinstance(data.get("alsa"), dict) else {}
    filter_block = (
        data.get("filter") if isinstance(data.get("filter"), dict) else {}
    )

    def alsa_value(key: str, legacy: str):
        return alsa_block.get(key, data.get(legacy))

    eq_profile = data.get("eqProfile")
    eq_profile_path = data.get("eqProfilePath")
    eq_enabled = data.get("eqEnabled")
    if eq_profile_path is None:
        if eq_enabled is None and eq_profile:
            eq_profile_path = _profile_path_for(eq_profile)
        else:
            eq_enabled = bool(eq_enabled)
    if eq_enabled is None:
        eq_enabled = bool(eq_profile_path)
    if eq_profile is None and eq_profile_path:
        eq_profile = Path(eq_profile_path).stem

    alsa_values = {
        "input_device": alsa_value("inputDevice", "alsaInputDevice"),
        "output_device": alsa_value("outputDevice", "alsaOutputDevice"),
        "sample_rate": alsa_value("sampleRate", "alsaSampleRate"),
        "channels": alsa_value("channels", "alsaChannels"),
        "format": alsa_value("format", "alsaFormat"),
        "period_frames": alsa_block.get("periodFrames"),
        "buffer_frames": alsa_block.get("bufferFrames"),
        "dither": alsa_block.get("dither"),
    }
    alsa = (
        AlsaSettings(**alsa_values)
        if any(v is not None for v in alsa_values.values())
        else None
    )

    filter_values = {
        "ratio": filter_block.get("ratio"),
        "phase_type": filter_block.get("phaseType"),
        "directory": filter_block.get("directory"),
    }
    filt = (
        FilterSettings(**filter_values)
        if any(v is not None for v in filter_values.values())
        else None
    )

    return Settings(
        eq_enabled=bool(eq_enabled and eq_profile_path),
        eq_profile=eq_profile,
        eq_profile_path=eq_profile_path,
        alsa=alsa,
        filter=filt,
    )


def save_config(settings: Settings, path: Path | None = None) -> bool:
    """Write settings, preserving unknown fields and dropping legacy keys."""
    path = path or config_path()
    try:
        existing = load_raw_config(path)
        eq_profile_path = settings.eq_profile_path or _profile_path_for(
            settings.eq_profile
        )
        eq_enabled = settings.eq_enabled and bool(eq_profile_path)
        existing["eqEnabled"] = eq_enabled
        existing["eqProfile"] = settings.eq_profile if eq_enabled else None
        existing["eqProfilePath"] = eq_profile_path if eq_enabled else None

        if settings.alsa is not None:
            block = existing.get("alsa")
            if not isinstance(block, dict):
                block = {}
            block.update({
                "inputDevice": settings.alsa.input_device,
                "outputDevice": settings.alsa.output_device,
                "sampleRate": settings.alsa.sample_rate,
                "channels": settings.alsa.channels,
                "format": settings.alsa.format,
                "periodFrames": settings.alsa.period_frames,
                "bufferFrames": settings.alsa.buffer_frames,
                "dither": settings.alsa.dither,
            })
            existing["alsa"] = block
            for legacy in _LEGACY_ALSA_KEYS:
                existing.pop(legacy, None)

        if settings.filter is not None:
            block = existing.get("filter")
            if not isinstance(block, dict):
                block = {}
            block.update({
                "ratio": settings.filter.ratio,
                "phaseType": settings.filter.phase_type,
                "directory": settings.filter.directory,
            })
            existing["filter"] = block

        path.write_text(json.dumps(existing, indent=2))
        return True
    except OSError:
        return False


def save_config_updates(updates: dict[str, Any], path: Path | None = None) -> bool:
    """Shallow-merge raw camelCase updates into config.json (PATCH)."""
    path = path or config_path()
    try:
        existing = load_raw_config(path)
        for key, value in updates.items():
            if (
                isinstance(value, dict)
                and isinstance(existing.get(key), dict)
            ):
                existing[key].update(value)
            else:
                existing[key] = value
        path.write_text(json.dumps(existing, indent=2))
        return True
    except OSError:
        return False
