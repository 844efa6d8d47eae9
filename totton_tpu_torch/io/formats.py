"""Allowed PCM format/rate sets — single source of truth.

Parity with the reference's constexpr PcmFormatSet
(include/audio/pcm_format_set.h:44-92): formats {S16_LE, S24_3LE, S32_LE},
2+ channels (the reference requires exactly 2; we generalize), and the two
power-of-two rate ladders of the 44.1k and 48k families.
"""

from __future__ import annotations

from totton_tpu_torch.io.pcm import PcmFormat


class PcmFormatSet:
    ALLOWED_FORMATS = (PcmFormat.S16_LE, PcmFormat.S24_3LE, PcmFormat.S32_LE)
    REQUIRED_CHANNELS = 2

    RATES_44K = (44100, 88200, 176400, 352800, 705600)
    RATES_48K = (48000, 96000, 192000, 384000, 768000)

    #: Family target output rates (reference: include/io/dac_capability.h:44-45)
    TARGET_RATE_44K = 705600
    TARGET_RATE_48K = 768000

    @classmethod
    def is_allowed_sample_rate(cls, rate: int) -> bool:
        return rate in cls.RATES_44K or rate in cls.RATES_48K

    @classmethod
    def is_44k_family_rate(cls, rate: int) -> bool:
        return rate in cls.RATES_44K

    @classmethod
    def is_48k_family_rate(cls, rate: int) -> bool:
        return rate in cls.RATES_48K
