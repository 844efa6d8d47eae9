"""The EQ cascade's CUDA source, run on the CPU: ``csrc/biquad_cascade.cu``
is compiled with g++ against the small ``cuda_runtime.h`` of
``torch_cuda_shim`` (each lane of a block a ``std::thread``,
``__syncwarp`` a ``std::barrier``, ``__fmaf_rn`` ``std::fmaf``). The
library is driven through the wrapper's own launch loop
(``eq.iir._launch``: groups of ``MAX_BANDS`` bands, later groups in
place) on CPU tensors and held against ``cascade_plain`` bit for bit,
with a carried state."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cuda_shim import build_library
from totton_tpu_torch.eq import iir
from totton_tpu_torch.eq.apo import parse_eq_string

torch.set_num_threads(2)

SOURCE = Path(iir.__file__).resolve().parents[1] / "csrc" / "biquad_cascade.cu"

FS = 44100.0
#: Forty PK, LS and HS bands at 44.1 kHz: the first ten an APO headphone
#: profile's (as in tests/test_torch_iir.py), the rest peaks spread over
#: the band; a case takes the first ``bands``.
PROFILE_40 = """Preamp: -6 dB
Filter 1: ON PK Fc 31 Hz Gain 2.5 dB Q 1.2
Filter 2: ON LS Fc 105 Hz Gain 4 dB Q 0.7
Filter 3: ON PK Fc 220 Hz Gain -1.5 dB Q 1.4
Filter 4: ON PK Fc 500 Hz Gain 1 dB Q 2.0
Filter 5: ON PK Fc 1000 Hz Gain 3 dB Q 1.0
Filter 6: ON PK Fc 2200 Hz Gain -2 dB Q 3.0
Filter 7: ON PK Fc 4000 Hz Gain 2 dB Q 2.5
Filter 8: ON PK Fc 6500 Hz Gain -3 dB Q 4.0
Filter 9: ON HS Fc 8000 Hz Gain -2 dB Q 0.7
Filter 10: ON PK Fc 12000 Hz Gain 1.5 dB Q 1.0
""" + "".join(f"Filter {11 + i}: ON PK Fc {300 + 500 * i} Hz Gain "
              f"{1 if i % 2 else -1} dB Q 2\n" for i in range(30))


def _profile_text(bands: int) -> str:
    return "\n".join(PROFILE_40.splitlines()[:bands + 1]) + "\n"


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    return iir._bind(build_library(SOURCE,
                                   tmp_path_factory.mktemp("cascade_source")))


def _inputs(bands: int, n: int):
    coeffs, preamp = iir.profile_to_coeff_matrix(
        parse_eq_string(_profile_text(bands)), FS)
    assert coeffs.shape[0] == bands
    rng = np.random.default_rng(100 * bands + n)
    x = torch.from_numpy((rng.normal(size=(2, n)) * 0.3).astype(np.float32))
    state = torch.from_numpy(
        (rng.normal(size=(2, bands, 2)) * 0.01).astype(np.float32))
    return x, torch.from_numpy(coeffs), state, preamp


@pytest.mark.parametrize("n", [1, 33, 4096])
@pytest.mark.parametrize("bands", [1, 10, 32, 40])
def test_kernel_source_matches_plain(shim_lib, bands, n):
    """The real kernel source equals the plain version bit for bit: y and
    the new state, one launch up to 32 bands and two at 40."""
    x, coeffs, state, preamp = _inputs(bands, n)
    before = iir.LAUNCHES
    y, st = iir._launch(shim_lib, x, coeffs, state, preamp, None)
    assert iir.LAUNCHES - before == -(-bands // iir.MAX_BANDS)
    ref, ref_st = iir.cascade_plain(x, coeffs, state, preamp)
    assert torch.isfinite(y).all()
    assert torch.equal(y, ref)
    assert torch.equal(st, ref_st)


def test_kernel_source_streams_and_refuses(shim_lib):
    """Two calls with the state carried equal one call, at a partial tile
    (31 samples, then 33); the C entry refuses what it cannot run."""
    x, coeffs, state, preamp = _inputs(10, 64)
    y1, s1 = iir._launch(shim_lib, x[:, :31].contiguous(), coeffs, state,
                         preamp, None)
    y2, s2 = iir._launch(shim_lib, x[:, 31:].contiguous(), coeffs, s1,
                         preamp, None)
    y, st = iir._launch(shim_lib, x, coeffs, state, preamp, None)
    assert torch.equal(torch.cat([y1, y2], 1), y)
    assert torch.equal(s2, st)
    fn = shim_lib.totton_biquad_cascade
    out = torch.empty_like(x)
    args = (x.data_ptr(), out.data_ptr(), coeffs.data_ptr(),
            state.data_ptr(), state.clone().data_ptr(), preamp)
    for bands, off, total, n in ((33, 0, 33, 64), (0, 0, 10, 64),
                                 (5, 6, 10, 64), (10, 0, 10, 0)):
        assert fn(*args, 2, n, bands, off, total, None) != 0
