"""Web-layer constants and validation bounds.

The VALUES here are the compatibility contract shared with the reference's
web/constants.py — TOTTON_* env-var names, the Equalizer-APO validation
envelope, and the safe-filename rules — so they match numerically; the
organization (bounds dataclass, path resolvers) is this framework's own.
"""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path

WEB_DIR = Path(__file__).parent


def _env_path(var: str, default: str) -> Path:
    return Path(os.environ.get(var, default))


def config_path() -> Path:
    return _env_path("TOTTON_CONFIG_PATH", "config.json")


def eq_profiles_dir() -> Path:
    return _env_path("TOTTON_EQ_DIR", "data/EQ")


def coefficients_dir() -> Path:
    return _env_path("TOTTON_FILTER_DIR", "data/coefficients")


ZMQ_ENDPOINT = os.environ.get("TOTTON_ZMQ_ENDPOINT", "ipc:///tmp/totton_zmq.sock")
STATS_FILE_PATH = _env_path("TOTTON_STATS_PATH", "/tmp/gpu_upsampler_stats.json")

PHASE_TYPE_MINIMUM = "minimum"
PHASE_TYPE_LINEAR = "linear"


@dataclasses.dataclass(frozen=True)
class EqBounds:
    """Equalizer-APO profile validation envelope (contract values)."""

    max_file_bytes: int = 1 * 1024 * 1024
    max_filters: int = 100
    preamp_db: tuple[float, float] = (-100.0, 20.0)
    freq_hz: tuple[float, float] = (10.0, 24000.0)
    gain_db: tuple[float, float] = (-30.0, 30.0)
    q: tuple[float, float] = (0.01, 100.0)


EQ_BOUNDS = EqBounds()

# Flat aliases used across the validation service and tests.
MAX_EQ_FILE_SIZE = EQ_BOUNDS.max_file_bytes
MAX_EQ_FILTERS = EQ_BOUNDS.max_filters
PREAMP_MIN_DB, PREAMP_MAX_DB = EQ_BOUNDS.preamp_db
FREQ_MIN_HZ, FREQ_MAX_HZ = EQ_BOUNDS.freq_hz
GAIN_MIN_DB, GAIN_MAX_DB = EQ_BOUNDS.gain_db
Q_MIN, Q_MAX = EQ_BOUNDS.q

# Uploaded profile filenames / profile names (path-traversal safety).
SAFE_FILENAME_PATTERN = re.compile(r"^[a-zA-Z0-9_\-\.]+\.txt$")
SAFE_PROFILE_NAME_PATTERN = re.compile(r"^[a-zA-Z0-9_\-\.]+$")
