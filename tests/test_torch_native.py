"""The port's copy of the native host runtime: PCM conversions bit for bit
with the JAX package's ``io.pcm``, with the native library and without it
(``TOTTON_NATIVE=0``), and the library built into the port's build root,
never next to its source."""

import os
import shutil

import numpy as np
import pytest

from totton_tpu.io import pcm as ref_pcm
from totton_tpu_torch import native
from totton_tpu_torch.io import pcm
from totton_tpu_torch.ops import _build

FORMATS = ("S16_LE", "S24_3LE", "S32_LE")


@pytest.fixture(params=["0", "1"], ids=["python", "native"])
def fresh_native(request, monkeypatch, tmp_path):
    """The port's native module reloaded under TOTTON_NATIVE=<param>, its
    library built into a fresh build root under tmp_path."""
    if request.param == "1" and shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library")
    monkeypatch.setenv("TOTTON_NATIVE", request.param)
    lib_path = str(tmp_path / "build" / "native" / "_totton_native.so")
    monkeypatch.setattr(native, "_LIB_PATH", lib_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    return request.param, lib_path


def _signal(n=4097, seed=0):
    r = np.random.default_rng(seed)
    x = r.uniform(-1.2, 1.2, size=n).astype(np.float32)
    x[:6] = [-1.0, 1.0, 0.9999695, -0.9999999, 0.0, 1.5]
    return x


@pytest.mark.parametrize("name", FORMATS)
def test_pcm_bit_exact_with_reference(fresh_native, name):
    mode, lib_path = fresh_native
    fmt, ref_fmt = pcm.PcmFormat(name), ref_pcm.PcmFormat(name)
    x = _signal()
    raw = pcm.float_to_pcm(x, fmt)
    assert raw == ref_pcm.float_to_pcm(x, ref_fmt)
    back = pcm.pcm_to_float(raw, fmt)
    np.testing.assert_array_equal(back, ref_pcm.pcm_to_float(raw, ref_fmt))
    frames = x[:4096].reshape(2, 2048)
    np.testing.assert_array_equal(pcm.interleave(frames),
                                  ref_pcm.interleave(frames))
    np.testing.assert_array_equal(
        pcm.deinterleave(back[:4096], 2), ref_pcm.deinterleave(back[:4096], 2))
    assert native.available() == (mode == "1")
    assert os.path.exists(lib_path) == (mode == "1")


def test_native_builds_outside_its_source_tree():
    """The default library path lies under the port's build root, not in
    the package's native/ directory, and no library sits there."""
    src_dir = os.path.dirname(os.path.abspath(native.__file__))
    lib_dir = os.path.dirname(os.path.abspath(native._LIB_PATH))
    assert lib_dir == os.path.join(os.path.abspath(_build.build_root()),
                                   "native")
    assert not lib_dir.startswith(src_dir)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


def test_native_ring_buffer_roundtrip(fresh_native):
    from totton_tpu_torch.io.ring_buffer import make_ring_buffer

    mode, _ = fresh_native
    ring = make_ring_buffer(1024)
    assert isinstance(ring, native.NativeRingBuffer) == (mode == "1")
    x = _signal(700, seed=3)
    assert ring.write(x)
    assert ring.available_to_read() == 700
    np.testing.assert_array_equal(ring.read(700), x)
