"""KB5000_7 "Modern Target" correction constants.

Parity with the reference's scripts/modern_target.py:43-63: a two-band
Harman-base correction (primary PK 5366 Hz +2.8 dB Q 1.5, secondary PK
2350 Hz -0.9 dB Q 2.0) with matching tolerances used when re-identifying
correction bands in saved profiles.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CorrectionBand:
    filter_type: str
    frequency: float
    gain_db: float
    q: float


@dataclasses.dataclass(frozen=True)
class CorrectionTolerance:
    frequency_primary: float
    frequency_secondary: float
    gain_db: float
    q: float


@dataclasses.dataclass(frozen=True)
class ModernTargetSpec:
    name: str
    primary: CorrectionBand
    secondary: CorrectionBand
    tolerance: CorrectionTolerance

    @property
    def filters(self) -> tuple[CorrectionBand, CorrectionBand]:
        return (self.primary, self.secondary)

    def matches_primary(self, frequency: float, gain_db: float, q: float) -> bool:
        t = self.tolerance
        p = self.primary
        return (
            abs(frequency - p.frequency) <= t.frequency_primary
            and abs(gain_db - p.gain_db) <= t.gain_db
            and abs(q - p.q) <= t.q
        )

    def matches_secondary(self, frequency: float, gain_db: float, q: float) -> bool:
        t = self.tolerance
        s = self.secondary
        return (
            abs(frequency - s.frequency) <= t.frequency_secondary
            and abs(gain_db - s.gain_db) <= t.gain_db
            and abs(q - s.q) <= t.q
        )

    def matches_any(self, frequency: float, gain_db: float, q: float) -> bool:
        return self.matches_primary(frequency, gain_db, q) or self.matches_secondary(
            frequency, gain_db, q
        )


MODERN_TARGET_SPEC = ModernTargetSpec(
    name="KB5000_7",
    primary=CorrectionBand("PK", 5366.0, 2.8, 1.5),
    secondary=CorrectionBand("PK", 2350.0, -0.9, 2.0),
    tolerance=CorrectionTolerance(
        frequency_primary=0.6,
        frequency_secondary=1.2,
        gain_db=0.1,
        q=0.05,
    ),
)

#: The band applied by apply_modern_target_correction.
MODERN_TARGET_CORRECTION_BAND = MODERN_TARGET_SPEC.primary
