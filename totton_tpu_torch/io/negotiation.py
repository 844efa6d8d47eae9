"""Sample-rate auto-negotiation.

Parity with the reference's AutoNegotiation (src/audio/auto_negotiation.cpp):
detect the input's rate family (44.1k/48k by divisibility), pick the highest
sink-supported output rate in that family (preferring the 705.6k / 768k
targets), and derive an integer upsample ratio restricted to {1, 2, 4, 8,
16}. Reconfiguration is required on first negotiation or family change.
"""

from __future__ import annotations

import dataclasses

from totton_tpu_torch.io.devices import SinkCapability
from totton_tpu_torch.io.formats import PcmFormatSet

SUPPORTED_RATIOS = (1, 2, 4, 8, 16)


class NegotiationError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class NegotiationResult:
    input_rate: int
    output_rate: int
    ratio: int
    family: int  # 44 or 48
    requires_reconfiguration: bool


def rate_family(rate: int) -> int:
    if rate <= 0:
        raise NegotiationError(f"invalid rate: {rate}")
    if rate % 44100 == 0:
        return 44
    if rate % 48000 == 0:
        return 48
    raise NegotiationError(f"Unsupported input rate family: {rate}")


def best_rate_for_family(family: int, capability: SinkCapability) -> int:
    """Highest supported rate in the family's ladder, preferring the target."""
    ladder = (
        PcmFormatSet.RATES_44K if family == 44 else PcmFormatSet.RATES_48K
    )
    for rate in sorted(ladder, reverse=True):
        if capability.is_rate_supported(rate):
            return rate
    raise NegotiationError(
        f"sink supports no {family}k-family rate (capability={capability})"
    )


def calculate_upsample_ratio(input_rate: int, output_rate: int) -> int:
    """Integer ratio restricted to {1,2,4,8,16}; raises otherwise
    (reference: auto_negotiation.cpp:125-130)."""
    if input_rate <= 0 or output_rate % input_rate != 0:
        raise NegotiationError(
            f"output rate {output_rate} not an integer multiple of input "
            f"{input_rate}"
        )
    ratio = output_rate // input_rate
    if ratio not in SUPPORTED_RATIOS:
        raise NegotiationError(f"unsupported upsample ratio: {ratio}")
    return ratio


class AutoNegotiator:
    """Stateful negotiator tracking family changes across renegotiations."""

    def __init__(self) -> None:
        self._last_family: int | None = None

    def negotiate(
        self, input_rate: int, capability: SinkCapability
    ) -> NegotiationResult:
        family = rate_family(input_rate)
        output_rate = best_rate_for_family(family, capability)
        if output_rate < input_rate:
            # Sink can't reach the input rate: passthrough at input rate if
            # supported, else fail.
            if capability.is_rate_supported(input_rate):
                output_rate = input_rate
            else:
                raise NegotiationError(
                    f"sink supports neither upsampled nor input rate "
                    f"{input_rate}"
                )
        ratio = calculate_upsample_ratio(input_rate, output_rate)
        requires_reconfig = self._last_family != family
        self._last_family = family
        return NegotiationResult(
            input_rate=input_rate,
            output_rate=output_rate,
            ratio=ratio,
            family=family,
            requires_reconfiguration=requires_reconfig,
        )
