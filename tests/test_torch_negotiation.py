"""Port parity: ``totton_tpu_torch/io/negotiation.py`` (a copy of the JAX
package's) against the reference on the reference suite's cases
(tests/test_io.py TestNegotiation): rate families, the best rate of a
family for a sink, the upsampling ratio and the negotiator's sequence."""

import dataclasses

import pytest

from totton_tpu.io import devices as ref_devices
from totton_tpu.io import negotiation as ref
from totton_tpu.io.formats import PcmFormatSet as RefFormats

torch = pytest.importorskip("torch")

from totton_tpu_torch.io import devices
from totton_tpu_torch.io import negotiation as port
from totton_tpu_torch.io.formats import PcmFormatSet

SINKS = {
    "full": tuple(PcmFormatSet.RATES_44K + PcmFormatSet.RATES_48K),
    "192k": (44100, 48000, 96000, 192000, 88200, 176400),
    "44k only": (44100, 88200, 176400),
}


def _sinks(mod, name):
    return mod.SinkCapability(supported_rates=SINKS[name], name=name)


def _call(mod, fn, *args):
    try:
        out = getattr(mod, fn)(*args)
    except mod.NegotiationError as e:
        return f"NegotiationError: {e}"
    return dataclasses.asdict(out) if dataclasses.is_dataclass(out) else out


def test_rate_ladders_equal():
    assert PcmFormatSet.RATES_44K == RefFormats.RATES_44K
    assert PcmFormatSet.RATES_48K == RefFormats.RATES_48K


@pytest.mark.parametrize("rate", [44100, 88200, 48000, 768000, 44101, 0])
def test_rate_family_equal(rate):
    assert _call(port, "rate_family", rate) == _call(ref, "rate_family", rate)


@pytest.mark.parametrize("family", [44, 48])
@pytest.mark.parametrize("sink", sorted(SINKS))
def test_best_rate_equal(family, sink):
    assert (_call(port, "best_rate_for_family", family, _sinks(devices, sink))
            == _call(ref, "best_rate_for_family", family,
                     _sinks(ref_devices, sink)))


@pytest.mark.parametrize("pair", [(44100, 705600), (352800, 705600),
                                  (44100, 88100), (22050, 705600),
                                  (48000, 48000)])
def test_upsample_ratio_equal(pair):
    assert (_call(port, "calculate_upsample_ratio", *pair)
            == _call(ref, "calculate_upsample_ratio", *pair))


@pytest.mark.parametrize("sink", sorted(SINKS))
def test_negotiator_sequence_equal(sink):
    """The same input-rate sequence through both negotiators: the same
    results, reconfiguration flags included."""
    seq = [44100, 88200, 48000, 48000, 96000, 44100]
    out = []
    for mod, dev in ((port, devices), (ref, ref_devices)):
        neg = mod.AutoNegotiator()
        out.append([_negotiate(mod, neg, rate, _sinks(dev, sink))
                    for rate in seq])
    assert out[0] == out[1]
    if sink == "full":
        first = out[0][0]
        assert (first["output_rate"], first["ratio"], first["family"]) == (
            705600, 16, 44)


def _negotiate(mod, neg, rate, sink):
    try:
        return dataclasses.asdict(neg.negotiate(rate, sink))
    except mod.NegotiationError as e:
        return f"NegotiationError: {e}"
