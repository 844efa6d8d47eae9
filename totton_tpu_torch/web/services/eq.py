"""EQ profile intake for the web layer: name safety, content validation,
structured profile views.

The *behavioral* contract kept from the reference web service
(web/services/eq.py there): the numeric validation bounds and the report
dict keys (``valid``/``errors``/``warnings``/``preamp_db``/``filter_count``/
``recommended_preamp_db``) that the API surface exposes, plus the
path-traversal rules encoded by the filename patterns in
totton_tpu_torch.web.constants. Everything else — parsing, the per-type
requirement model, and all user-facing text — is this module's own.

Instead of a per-parameter regex battery, filter lines are read by a
single token walk (``scan_band_line``), and the per-type requirements are
derived from the engine-side APO taxonomy in totton_tpu_torch.eq.apo so the web
validator and the DSP parser can never disagree about which types exist.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

from totton_tpu_torch.eq import apo
from totton_tpu_torch.integration.modern_target import MODERN_TARGET_SPEC
from totton_tpu_torch.web.constants import (
    FREQ_MAX_HZ,
    FREQ_MIN_HZ,
    GAIN_MAX_DB,
    GAIN_MIN_DB,
    MAX_EQ_FILE_SIZE,
    MAX_EQ_FILTERS,
    PREAMP_MAX_DB,
    PREAMP_MIN_DB,
    Q_MAX,
    Q_MIN,
    SAFE_FILENAME_PATTERN,
    SAFE_PROFILE_NAME_PATTERN,
)

#: Every type the DSP-side parser knows (single source of truth).
KNOWN_TYPES = frozenset(ft.value for ft in apo.FilterType)

#: Types that are meaningless without a Gain value: every gain-defined
#: type in the engine taxonomy, plus all-pass (which APO specifies with
#: Gain even though the magnitude response ignores it).
GAIN_REQUIRED = frozenset(ft.value for ft in apo.GAIN_TYPES) | {"AP"}

#: Types that need a width parameter (Q, BW Oct, or BW Hz). The C-suffix
#: and fixed-slope shelves carry their slope in the type itself.
WIDTH_REQUIRED = frozenset(
    {"PK", "MODAL", "PEQ", "AP", "LS", "HS", "LSQ", "HSQ"}
)


def is_safe_profile_name(name: str | None) -> bool:
    """Profile names come from URL path segments; reject anything that
    could escape the EQ directory."""
    if not name:
        return True
    if not SAFE_PROFILE_NAME_PATTERN.match(name):
        return False
    return ".." not in name and not name.startswith(".")


def sanitize_filename(filename: str) -> str | None:
    """Reduce an uploaded filename to a safe basename, or None."""
    if not filename:
        return None
    base = filename.replace("\\", "/").rsplit("/", 1)[-1]
    if ".." in base or not SAFE_FILENAME_PATTERN.match(base):
        return None
    return base


# ---------------------------------------------------------------------------
# Token-walk scanner for "Filter N: ON TYPE Fc F Hz ..." lines
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BandLine:
    """One filter line as scanned (None = parameter absent on the line)."""

    declared_num: int | None = None
    enabled: bool = True
    type_name: str | None = None
    fc_hz: float | None = None
    gain_db: float | None = None
    q: float | None = None
    bw_oct: float | None = None
    bw_hz: float | None = None

    @property
    def has_width(self) -> bool:
        return (self.q is not None or self.bw_oct is not None
                or self.bw_hz is not None)

    def effective_q(self) -> float | None:
        if self.q is not None:
            return self.q
        if self.bw_oct is not None:
            return apo.bandwidth_oct_to_q(self.bw_oct)
        if self.bw_hz is not None and self.fc_hz is not None:
            return apo.bandwidth_hz_to_q(self.fc_hz, self.bw_hz)
        return None


def _number(token: str) -> float | None:
    try:
        return float(token)
    except ValueError:
        return None


def is_filter_line(line: str) -> bool:
    """A line that *claims* to be a filter directive (it may still fail
    to scan — the validator wants to warn about those, not skip them)."""
    lowered = line.lstrip().lower()
    return lowered.startswith("filter:") or lowered.startswith("filter ")


def scan_band_line(line: str) -> BandLine | None:
    """Scan one filter line by walking its whitespace tokens.

    Grammar: ``Filter [N]: ON|OFF TYPE... Fc F [Hz] [Gain G dB]
    [Q q | BW Oct o | BW b Hz]``. Returns None when the line doesn't
    follow the shape at all (caller decides whether that's an error).
    """
    if ":" not in line or not is_filter_line(line):
        return None
    head, _, rest = line.partition(":")
    band = BandLine()
    head_tokens = head.split()
    if len(head_tokens) == 2 and head_tokens[1].isdigit():
        band.declared_num = int(head_tokens[1])

    tokens = rest.split()
    if not tokens or tokens[0].upper() not in ("ON", "OFF"):
        return None
    band.enabled = tokens[0].upper() == "ON"

    # Type = every token up to the Fc keyword (handles "LS 6DB").
    i = 1
    type_tokens: list[str] = []
    while i < len(tokens) and tokens[i].upper() != "FC":
        type_tokens.append(tokens[i].upper())
        i += 1
    if not type_tokens or i >= len(tokens):
        return None
    band.type_name = " ".join(type_tokens)

    i += 1  # past "Fc"
    if i >= len(tokens):
        return None
    fc_tok = tokens[i]
    # Accept a glued unit ("1000Hz", "2kHz") or a separate one ("2 kHz");
    # kHz scales x1000 in the DSP parser (eq/apo.py) and here alike.
    scale = 1.0
    unit_seen = False
    if fc_tok.lower().endswith("khz"):
        fc_tok, scale, unit_seen = fc_tok[:-3], 1000.0, True
    elif fc_tok.lower().endswith("hz"):
        fc_tok, unit_seen = fc_tok[:-2], True
    band.fc_hz = _number(fc_tok)
    if band.fc_hz is None:
        return None
    i += 1
    if not unit_seen and i < len(tokens) and tokens[i].lower() in ("hz", "khz"):
        if tokens[i].lower() == "khz":
            scale = 1000.0
        i += 1
    band.fc_hz *= scale

    # Remaining parameters, in any order.
    while i < len(tokens):
        key = tokens[i].upper()
        if key == "GAIN" and i + 1 < len(tokens):
            band.gain_db = _number(tokens[i + 1])
            i += 2
            if i < len(tokens) and tokens[i].lower() == "db":
                i += 1
        elif key == "Q" and i + 1 < len(tokens):
            band.q = _number(tokens[i + 1])
            i += 2
        elif key == "BW" and i + 1 < len(tokens):
            if tokens[i + 1].upper() == "OCT" and i + 2 < len(tokens):
                band.bw_oct = _number(tokens[i + 2])
                i += 3
            else:
                band.bw_hz = _number(tokens[i + 1])
                i += 2
                if i < len(tokens) and tokens[i].lower() == "hz":
                    i += 1
        else:
            i += 1
    return band


def is_correction_band(band: BandLine | None) -> bool:
    """True when a scanned band is one of the Modern Target (KB5000_7)
    correction peaks rather than a headphone-EQ band."""
    if band is None or band.type_name != "PK":
        return False
    if band.fc_hz is None or band.gain_db is None:
        return False
    q = band.effective_q()
    if q is None:
        return False
    return MODERN_TARGET_SPEC.matches_any(band.fc_hz, band.gain_db, q)


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def _scan_preamp(line: str) -> tuple[bool, float | None]:
    """(is_preamp_line, value or None when unreadable).

    Mirrors the DSP parser exactly (eq/apo.py ``_PREAMP_RE``): the value
    must be a number followed by a dB suffix — glued ("-6dB") or spaced
    ("-6 dB") — ending the line. A bare number is UNREADABLE here because
    the engine ignores that line (preamp 0); reporting it as valid would
    claim headroom the engine won't apply."""
    head, sep, rest = line.partition(":")
    if not sep or head.strip().lower() != "preamp":
        return False, None
    value = rest.strip()
    if not value.lower().endswith("db"):
        return True, None
    return True, _number(value[:-2].strip())


def _check_band(band: BandLine, label: int | str,
                errors: list[str], warnings: list[str]) -> float:
    """Range/requirement checks for one band; returns its positive boost
    contribution (0 when disabled or cutting)."""
    t = band.type_name
    if t not in KNOWN_TYPES:
        warnings.append(f"Band {label}: unrecognized filter type '{t}'")
    else:
        if t in GAIN_REQUIRED and band.gain_db is None:
            errors.append(f"Band {label}: {t} needs a Gain value")
        if t in WIDTH_REQUIRED and not band.has_width:
            errors.append(
                f"Band {label}: {t} needs a width (Q, BW Oct, or BW Hz)"
            )
    if band.fc_hz is not None and not (
            FREQ_MIN_HZ <= band.fc_hz <= FREQ_MAX_HZ):
        errors.append(
            f"Band {label}: Fc must be between {FREQ_MIN_HZ} and "
            f"{FREQ_MAX_HZ} Hz (got {band.fc_hz:g})"
        )
    boost = 0.0
    if band.gain_db is not None:
        if not GAIN_MIN_DB <= band.gain_db <= GAIN_MAX_DB:
            errors.append(
                f"Band {label}: gain must be between {GAIN_MIN_DB} and "
                f"{GAIN_MAX_DB} dB (got {band.gain_db:g})"
            )
        elif band.enabled:
            boost = max(0.0, band.gain_db)
    if band.q is not None and not Q_MIN <= band.q <= Q_MAX:
        errors.append(
            f"Band {label}: Q must be between {Q_MIN} and {Q_MAX} "
            f"(got {band.q:g})"
        )
    return boost


def validate_eq_profile_content(content: str) -> dict[str, Any]:
    """Validate APO profile text.

    Checks: a Preamp line exists and is in range; each filter line scans;
    known types carry their required parameters; Fc/gain/Q are inside the
    bounds from totton_tpu_torch.web.constants; the band count is capped; and a
    positive-boost profile gets a clipping-headroom recommendation.
    """
    errors: list[str] = []
    warnings: list[str] = []
    preamp_db: float | None = None
    seen_preamp = False
    band_count = 0
    peak_boost = 0.0

    if not content or not content.strip():
        return {
            "valid": False, "errors": ["Profile is empty"], "warnings": [],
            "preamp_db": None, "filter_count": 0,
            "recommended_preamp_db": 0.0,
        }

    for raw in content.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        is_preamp, value = _scan_preamp(line)
        if is_preamp:
            if seen_preamp:
                continue  # first Preamp line wins, as in the engine parser
            seen_preamp = True
            if value is None:
                warnings.append(f"Unreadable Preamp value: {line}")
            else:
                preamp_db = value
                if not PREAMP_MIN_DB <= value <= PREAMP_MAX_DB:
                    errors.append(
                        f"Preamp must be between {PREAMP_MIN_DB} and "
                        f"{PREAMP_MAX_DB} dB (got {value:g})"
                    )
            continue
        if not is_filter_line(line):
            continue
        band_count += 1
        band = scan_band_line(line)
        if band is None:
            preview = line if len(line) <= 50 else line[:50] + "..."
            warnings.append(f"Skipping unreadable filter line: {preview}")
            continue
        label = band.declared_num or band_count
        peak_boost = max(
            peak_boost, _check_band(band, label, errors, warnings)
        )

    if not seen_preamp:
        errors.append("No Preamp line in profile")
    if band_count > MAX_EQ_FILTERS:
        errors.append(
            f"Profile has {band_count} filter lines; at most "
            f"{MAX_EQ_FILTERS} are supported"
        )
    if band_count == 0 and seen_preamp:
        warnings.append("Profile defines no filters (Preamp only)")

    recommended = -peak_boost
    if peak_boost > 0 and preamp_db is not None and preamp_db > recommended:
        warnings.append(
            f"Boosts up to +{peak_boost:g} dB with preamp {preamp_db:g} dB "
            f"can clip; set preamp to {recommended:g} dB or below"
        )

    return {
        "valid": not errors,
        "errors": errors,
        "warnings": warnings,
        "preamp_db": preamp_db,
        "filter_count": band_count,
        "recommended_preamp_db": recommended if peak_boost > 0 else 0.0,
    }


def validate_upload(filename: str, content_bytes: bytes) -> tuple[str, str, dict]:
    """Gatekeep an uploaded profile file. Returns (text, safe_name,
    report); raises ValueError with a user-facing reason on rejection."""
    if not filename or not filename.endswith(".txt"):
        raise ValueError("EQ profiles must be .txt files")
    safe = sanitize_filename(filename)
    if not safe:
        raise ValueError(
            "Unsafe filename; stick to letters, digits, '_', '-' and '.'"
        )
    if len(content_bytes) > MAX_EQ_FILE_SIZE:
        raise ValueError(
            f"Profile exceeds the {MAX_EQ_FILE_SIZE // (1 << 20)} MB "
            "size limit"
        )
    try:
        text = content_bytes.decode("utf-8")
    except UnicodeDecodeError:
        raise ValueError("Profile is not valid UTF-8 text")
    report = validate_eq_profile_content(text)
    report["size_bytes"] = len(content_bytes)
    return text, safe, report


# ---------------------------------------------------------------------------
# Structured profile view
# ---------------------------------------------------------------------------

#: Attribution header fields an OPRA-applied profile carries (written by
#: the OPRA apply route; see totton_tpu/web/app.py).
_OPRA_HEADER_FIELDS = {
    "OPRA": "product",
    "Author": "author",
    "License": "license",
    "Source": "source",
    "Details": "details",
}


def parse_eq_profile_content(file_path: Path) -> dict[str, Any]:
    """Structured view of a saved profile for the UI: where it came from
    (OPRA attribution header vs custom upload), whether it carries Modern
    Target correction bands, and the band lines split accordingly."""
    if not file_path.exists():
        return {"error": "File not found"}
    try:
        content = file_path.read_text(encoding="utf-8")
    except OSError as e:
        return {"error": f"Failed to read file: {e}"}

    opra_info: dict[str, str] = {}
    band_lines: list[str] = []
    has_modern_target = False
    for raw in content.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            key, sep, value = line.lstrip("# ").partition(":")
            field = _OPRA_HEADER_FIELDS.get(key.strip())
            if sep and field:
                opra_info[field] = value.strip()
            if "Modern Target" in line:
                has_modern_target = True
            continue
        if _scan_preamp(line)[0] or is_filter_line(line):
            band_lines.append(line)

    is_opra = "product" in opra_info
    eq_bands: list[str] = []
    correction_bands: list[str] = []
    if is_opra and has_modern_target:
        for line in band_lines:
            if is_correction_band(scan_band_line(line)):
                correction_bands.append(line)
            else:
                eq_bands.append(line)
    else:
        eq_bands = band_lines

    return {
        "source_type": "opra" if is_opra else "custom",
        "has_modern_target": has_modern_target,
        "opra_info": opra_info or None,
        "opra_filters": eq_bands,
        "original_filters": correction_bands,
        "raw_content": content,
    }
