"""Port parity: totton_tpu_torch.eq.iir (the time-domain biquad cascade)
against the JAX package's ``_cascade_scan`` on the CPU, on the same seeded
numpy inputs; both against scipy's float64 ``lfilter``; streaming, state
carried over from JAX, and the CUDA kernel against the plain version
(marked ``cuda``: it skips without a card)."""

import numpy as np
import pytest
import torch
from scipy import signal as ssig

from totton_tpu.eq import iir as jax_iir
from totton_tpu.eq.apo import parse_eq_string as jax_parse
from totton_tpu_torch.convert import cascade_from_jax
from totton_tpu_torch.eq import iir
from totton_tpu_torch.eq.apo import parse_eq_string

torch.set_num_threads(2)

FS = 44100.0
#: The port's plain cascade against the JAX scan on the CPU, and the
#: kernel against the plain version on the card (rel to the output's
#: peak): the same float32 update in the same order with the same fused
#: multiply-adds, so 0 is expected; the limit leaves room for a double
#: rounding of the plain version's float64 emulation of a fused
#: multiply-add.
REL_TOL = 1e-5
#: Both against scipy's float64 lfilter: the reference suite's tolerance
#: (tests/test_eq.py::TestTimeDomainCascade).
SCIPY_RTOL, SCIPY_ATOL = 1e-3, 2e-4

#: Ten bands of PK, LS and HS (the kinds of an APO headphone profile).
PROFILE_10 = """Preamp: -6 dB
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
"""


def _profile_text(bands: int) -> str:
    lines = PROFILE_10.splitlines()
    return "\n".join(lines[:bands + 1]) + "\n"


def _signal(channels=2, n=2048, seed=0):
    return (np.random.default_rng(seed).normal(size=(channels, n))
            * 0.3).astype(np.float32)


def _jax_run(text, x, state=None):
    coeffs, preamp = jax_iir.profile_to_coeff_matrix(jax_parse(text), FS)
    if state is None:
        state = np.zeros((x.shape[0], coeffs.shape[0], 2), np.float32)
    y, st = jax_iir._cascade_scan(x, coeffs, state, np.float32(preamp))
    return np.asarray(y), np.asarray(st)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _lfilter(text, x):
    coeffs, preamp = iir.profile_to_coeff_matrix(parse_eq_string(text), FS)
    ref = x.astype(np.float64) * preamp
    for row in coeffs:
        ref = ssig.lfilter(row[:3].astype(np.float64),
                           np.concatenate([[1.0], row[3:]]).astype(
                               np.float64), ref, axis=-1)
    return ref


def test_coeff_matrix_matches_the_reference():
    for bands in (0, 3, 10):
        text = _profile_text(bands)
        a = iir.profile_to_coeff_matrix(parse_eq_string(text), FS)
        b = jax_iir.profile_to_coeff_matrix(jax_parse(text), FS)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


@pytest.mark.parametrize("bands", [2, 5, 10])
def test_plain_matches_jax_scan(bands):
    text = _profile_text(bands)
    x = _signal(seed=bands)
    y = iir.biquad_cascade(x, parse_eq_string(text), FS, device="cpu")
    ref, jst = _jax_run(text, x)
    assert y.shape == ref.shape == x.shape
    assert _rel(y, ref) <= REL_TOL
    coeffs, preamp = iir.profile_to_coeff_matrix(parse_eq_string(text), FS)
    _, st = iir.cascade(torch.from_numpy(x), torch.from_numpy(coeffs),
                        torch.zeros((2, coeffs.shape[0], 2)), preamp)
    np.testing.assert_allclose(st.numpy(), jst, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("bands", [2, 10])
def test_both_match_scipy_lfilter(bands):
    text = _profile_text(bands)
    x = _signal(seed=10 + bands)
    ref = _lfilter(text, x)
    port = iir.biquad_cascade(x, parse_eq_string(text), FS, device="cpu")
    jax_y = np.asarray(jax_iir.biquad_cascade(x, jax_parse(text), FS))
    np.testing.assert_allclose(port, ref, rtol=SCIPY_RTOL, atol=SCIPY_ATOL)
    np.testing.assert_allclose(jax_y, ref, rtol=SCIPY_RTOL, atol=SCIPY_ATOL)


def test_streaming_matches_one_shot():
    text = _profile_text(10)
    x = _signal(n=2048, seed=3)
    one_shot = iir.biquad_cascade(x, parse_eq_string(text), FS, device="cpu")
    c = iir.BiquadCascade(parse_eq_string(text), FS, 2, device="cpu")
    cuts = [0, 1, 300, 1024, 2048]
    y = np.concatenate([c.process(x[:, a:b])
                        for a, b in zip(cuts, cuts[1:])], axis=1)
    np.testing.assert_array_equal(y, one_shot)
    c.reset()
    np.testing.assert_array_equal(c.process(x), one_shot)


def test_make_cascade_step_matches_jax():
    text = _profile_text(6)
    x = _signal(n=1024, seed=4)
    step, state = iir.make_cascade_step(parse_eq_string(text), FS, 2,
                                        device="cpu")
    jstep, jstate = jax_iir.make_cascade_step(jax_parse(text), FS, 2)
    assert tuple(state.shape) == tuple(jstate.shape)
    ys, jys = [], []
    for i in range(0, 1024, 256):
        y, state = step(torch.from_numpy(x[:, i:i + 256]), state)
        jy, jstate = jstep(x[:, i:i + 256], jstate)
        ys.append(y.numpy())
        jys.append(np.asarray(jy))
    assert _rel(np.concatenate(ys, 1), np.concatenate(jys, 1)) <= REL_TOL


def test_state_carried_over_from_jax():
    """JAX runs the first half, its state goes to the port, the port runs
    the second half: the joined output equals JAX's one-shot run."""
    text = _profile_text(10)
    x = _signal(n=2048, seed=5)
    one_shot, _ = _jax_run(text, x)
    first, jstate = _jax_run(text, x[:, :1000])
    coeffs, preamp = jax_iir.profile_to_coeff_matrix(jax_parse(text), FS)
    state, c, p = cascade_from_jax(jstate, coeffs, preamp, device="cpu")
    second, _ = iir.cascade(torch.from_numpy(x[:, 1000:].copy()), c, state, p)
    joined = np.concatenate([first, second.numpy()], axis=1)
    assert _rel(joined, one_shot) <= REL_TOL


def test_cascade_from_jax_checks_shapes():
    with pytest.raises(ValueError, match="coeffs"):
        cascade_from_jax(np.zeros((2, 3, 2)), np.zeros((3, 4)), 1.0)
    with pytest.raises(ValueError, match="state"):
        cascade_from_jax(np.zeros((2, 2, 2)), np.zeros((3, 5)), 1.0)


def test_unsupported_device_raises():
    x = torch.zeros((1, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        iir.cascade(x.to("meta"), torch.zeros((1, 5), device="meta"),
                    torch.zeros((1, 1, 2), device="meta"), 1.0)


def test_cpu_never_launches_the_kernel():
    before = iir.LAUNCHES
    iir.biquad_cascade(_signal(n=64), parse_eq_string(_profile_text(3)), FS,
                       device="cpu")
    assert iir.LAUNCHES == before


def _cuda_case(bands, n, seed):
    """(x, coeffs, state, preamp) on the card: the first ``bands`` of
    PROFILE_10 and thirty more peaks, a non-zero carried state."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    text = PROFILE_10 + "".join(
        f"Filter {11 + i}: ON PK Fc {300 + 500 * i} Hz Gain "
        f"{1 if i % 2 else -1} dB Q 2\n" for i in range(30))
    prof = parse_eq_string(text)
    prof.bands = prof.bands[:bands]
    coeffs, preamp = iir.profile_to_coeff_matrix(prof, FS)
    dev = torch.device("cuda")
    x = torch.from_numpy(_signal(n=n, seed=seed)).to(dev)
    c = torch.from_numpy(coeffs).to(dev)
    s0 = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, coeffs.shape[0], 2)).astype(np.float32) * 0.01).to(dev)
    return x, c, s0, preamp


def _check_cuda(x, c, s0, preamp):
    before = iir.LAUNCHES
    y, st = iir.cascade(x, c, s0, preamp)
    torch.cuda.synchronize()
    assert iir.LAUNCHES - before == -(-c.shape[0] // iir.MAX_BANDS)
    ref, ref_st = iir.cascade_plain(x, c, s0, preamp)
    assert ((y - ref).abs().max() / ref.abs().max()).item() <= REL_TOL
    assert torch.allclose(st, ref_st, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("bands", [1, 10, 20, 32, 40])
def test_cuda_kernel_matches_plain(bands):
    """The kernel against the plain version on the card (40 bands: two
    launches of at most MAX_BANDS)."""
    _check_cuda(*_cuda_case(bands, 4096, 6))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_cuda_kernel_tails(n):
    """Partial tiles of 32 samples, with a carried state: the state after
    the last real sample."""
    _check_cuda(*_cuda_case(10, n, 7))
