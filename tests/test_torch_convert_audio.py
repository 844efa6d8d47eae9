"""Port parity: ``totton_tpu_torch/testing/convert_audio.py`` (a copy of
the JAX package's) against the reference on the reference suite's cases
(tests/test_convert_audio.py): WAV -> raw -> WAV at s16/s24/s32, the same
bytes from both CLIs, and the round trip within the format's LSB."""

import numpy as np
import pytest

from totton_tpu.testing.convert_audio import main as ref_main

torch = pytest.importorskip("torch")

from totton_tpu_torch.io.pcm import parse_format
from totton_tpu_torch.io.wav import read_wav, write_wav
from totton_tpu_torch.testing.convert_audio import main
from totton_tpu_torch.testing.signals import sine


@pytest.mark.parametrize("fmt", ["s16", "s24", "s32"])
def test_round_trip_equals_the_reference(tmp_path, fmt):
    x = sine(440.0, 0.05, 44100, amplitude=0.4, channels=2)
    src = tmp_path / "in.wav"
    f = parse_format(fmt)
    write_wav(str(src), x, 44100, fmt=f)
    outs = {}
    for name, run in (("port", main), ("ref", ref_main)):
        raw = tmp_path / f"{name}.raw"
        back = tmp_path / f"{name}.wav"
        assert run(["wav2raw", str(src), str(raw), "--format", fmt]) == 0
        assert run(["raw2wav", str(raw), str(back), "--rate", "44100",
                    "--channels", "2", "--format", fmt]) == 0
        outs[name] = (raw.read_bytes(), back.read_bytes())
    assert outs["port"] == outs["ref"]
    assert len(outs["port"][0]) == x.shape[1] * 2 * f.bytes
    y, rate = read_wav(str(tmp_path / "port.wav"))
    assert rate == 44100 and y.shape == x.shape
    np.testing.assert_allclose(y, x, atol=2 * 2.0 ** -(f.bytes * 8 - 1))
