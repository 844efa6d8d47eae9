"""Equalizer APO configuration-format parser.

Format (https://sourceforge.net/p/equalizerapo/wiki/ — same dialect the
reference parses, src/audio/eq_parser.cpp):

    Preamp: -6.5 dB
    Filter 1: ON PK Fc 1000 Hz Gain -3.0 dB Q 1.41
    Filter 2: ON LS Fc 105 Hz Gain 2 dB
    Filter 3: OFF HPQ Fc 50 Hz Q 0.7
    Filter 4: ON PK Fc 250 Hz Gain 1 dB BW Oct 0.5

Bandwidth conversions: Q = 1 / (2*sinh(ln2/2 * BWoct)) and Q = Fc / BWhz.

The port's copy of ``totton_tpu.eq.apo``: the JAX package's ``eq`` package
imports its jax cascade (``eq/iir.py``) on import, so the port carries
these framework-free modules itself. ``tests/test_torch_copies.py``
holds the copy to the reference.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import re


class FilterType(enum.Enum):
    # Peaking
    PK = "PK"
    MODAL = "MODAL"
    PEQ = "PEQ"
    # Pass
    LP = "LP"
    LPQ = "LPQ"
    HP = "HP"
    HPQ = "HPQ"
    BP = "BP"
    # Notch / all-pass
    NO = "NO"
    AP = "AP"
    # Shelf
    LS = "LS"
    HS = "HS"
    LSC = "LSC"
    HSC = "HSC"
    LSQ = "LSQ"
    HSQ = "HSQ"
    # Fixed-slope shelf
    LS_6DB = "LS 6DB"
    LS_12DB = "LS 12DB"
    HS_6DB = "HS 6DB"
    HS_12DB = "HS 12DB"


#: Types whose gain parameter defines the filter (bypass when gain == 0).
GAIN_TYPES = {
    FilterType.PK, FilterType.MODAL, FilterType.PEQ,
    FilterType.LS, FilterType.HS, FilterType.LSC, FilterType.HSC,
    FilterType.LSQ, FilterType.HSQ,
    FilterType.LS_6DB, FilterType.LS_12DB, FilterType.HS_6DB,
    FilterType.HS_12DB,
}


def bandwidth_oct_to_q(bw_oct: float) -> float:
    """Q from bandwidth in octaves: 1 / (2*sinh(ln2/2 * BW))."""
    if bw_oct <= 0.0:
        return 1.0
    denom = 2.0 * math.sinh(math.log(2.0) / 2.0 * bw_oct)
    return 1.0 / denom if denom > 0 else 1.0


def bandwidth_hz_to_q(fc: float, bw_hz: float) -> float:
    """Q from absolute bandwidth: Fc / BW."""
    if fc <= 0.0 or bw_hz <= 0.0:
        return 1.0
    return fc / bw_hz


@dataclasses.dataclass
class EqBand:
    enabled: bool = True
    type: FilterType = FilterType.PK
    frequency: float = 1000.0
    gain: float = 0.0
    q: float = 1.0
    bandwidth_hz: float | None = None
    bandwidth_oct: float | None = None


@dataclasses.dataclass
class EqProfile:
    name: str = ""
    preamp_db: float = 0.0
    bands: list[EqBand] = dataclasses.field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return not self.bands and self.preamp_db == 0.0

    @property
    def active_band_count(self) -> int:
        return sum(1 for b in self.bands if b.enabled)


_PREAMP_RE = re.compile(r"^\s*Preamp\s*:\s*(-?[\d.]+)\s*dB\s*$", re.IGNORECASE)
# Filter N: ON|OFF TYPE Fc F Hz [Gain G dB] [Q q | BW Oct o | BW b Hz]
# The kHz unit scales by 1000 (the reference regex consumes a stray 'k'
# without scaling — src/audio/eq_parser.cpp:188 reads "Fc 2 kHz" as 2 Hz;
# fixed here, and the web validator applies the same x1000).
_FILTER_RE = re.compile(
    r"^\s*Filter\s*\d*\s*:\s*(ON|OFF)\s+"
    r"([A-Z]+(?:\s+(?:6|12)DB)?)\s+"
    r"Fc\s+(-?[\d.]+)\s*(k?)Hz(.*)$",
    re.IGNORECASE,
)
_GAIN_RE = re.compile(r"Gain\s+(-?[\d.]+)\s*dB", re.IGNORECASE)
_Q_RE = re.compile(r"\bQ\s+(-?[\d.]+)", re.IGNORECASE)
_BW_OCT_RE = re.compile(r"BW\s+Oct\s+(-?[\d.]+)", re.IGNORECASE)
_BW_HZ_RE = re.compile(r"BW\s+(-?[\d.]+)\s*Hz", re.IGNORECASE)


def parse_filter_type(token: str) -> FilterType:
    norm = " ".join(token.upper().split())
    for ft in FilterType:
        if ft.value == norm:
            return ft
    raise ValueError(f"Unknown filter type: {token!r}")


def parse_eq_string(content: str, name: str = "") -> EqProfile:
    """Parse APO text into an EqProfile. Unparseable lines are skipped
    (same leniency as the reference parser)."""
    profile = EqProfile(name=name)
    for raw_line in content.splitlines():
        line = raw_line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PREAMP_RE.match(line)
        if m:
            profile.preamp_db = float(m.group(1))
            continue
        m = _FILTER_RE.match(line)
        if not m:
            continue
        enabled_tok, type_tok, fc_tok, k_tok, rest = m.groups()
        try:
            ftype = parse_filter_type(type_tok)
        except ValueError:
            continue
        band = EqBand(
            enabled=enabled_tok.upper() == "ON",
            type=ftype,
            frequency=float(fc_tok) * (1000.0 if k_tok else 1.0),
        )
        gm = _GAIN_RE.search(rest)
        if gm:
            band.gain = float(gm.group(1))
        bw_oct = _BW_OCT_RE.search(rest)
        bw_hz = None if bw_oct else _BW_HZ_RE.search(rest)
        qm = _Q_RE.search(rest)
        if qm:
            band.q = float(qm.group(1))
        elif bw_oct:
            band.bandwidth_oct = float(bw_oct.group(1))
            band.q = bandwidth_oct_to_q(band.bandwidth_oct)
        elif bw_hz:
            band.bandwidth_hz = float(bw_hz.group(1))
            band.q = bandwidth_hz_to_q(band.frequency, band.bandwidth_hz)
        profile.bands.append(band)
    return profile


def parse_eq_file(path: str, name: str | None = None) -> EqProfile:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        content = f.read()
    import os

    return parse_eq_string(
        content, name if name is not None else os.path.basename(path)
    )
