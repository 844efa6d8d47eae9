"""Port parity: totton_tpu_torch.ops.fft (fft2, ifft2, rfft2, irfft2)
against the JAX package's matmul DFT and against torch.fft, on the CPU.

Inputs come from numpy with a seed. Tolerance: rel < 1e-5 of the largest
magnitude, float32 with another summation order than either reference."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from totton_tpu.ops import fft as jfft
from totton_tpu_torch.ops import fft as tfft

torch.set_num_threads(2)

SIZES = [2, 8, 64, 1024, 4096]


def _rel(y, ref):
    return np.abs(np.asarray(y) - np.asarray(ref)).max() / max(
        np.abs(np.asarray(ref)).max(), 1e-30)


def _complex(rng, n):
    return (rng.normal(size=(3, n)).astype(np.float32),
            rng.normal(size=(3, n)).astype(np.float32))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("inverse", [False, True])
def test_fft2_ifft2_match_jax_and_torch_fft(rng, n, inverse):
    xr, xi = _complex(rng, n)
    tf, jf = (tfft.ifft2, jfft.ifft2) if inverse else (tfft.fft2, jfft.fft2)
    yr, yi = tf(torch.from_numpy(xr), torch.from_numpy(xi))
    jr, ji = jf(jnp.asarray(xr), jnp.asarray(xi))
    z = torch.from_numpy(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    ref = (torch.fft.ifft if inverse else torch.fft.fft)(z).numpy()
    got = yr.numpy() + 1j * yi.numpy()
    assert _rel(got, np.asarray(jr) + 1j * np.asarray(ji)) < 1e-5
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("n", SIZES)
def test_rfft2_matches_jax_and_torch_fft(rng, n):
    x = rng.normal(size=(2, 3, n)).astype(np.float32)
    yr, yi = tfft.rfft2(torch.from_numpy(x))
    jr, ji = jfft.rfft2(jnp.asarray(x))
    ref = torch.fft.rfft(torch.from_numpy(x.astype(np.float64))).numpy()
    got = yr.numpy() + 1j * yi.numpy()
    assert got.shape == ref.shape == (2, 3, n // 2 + 1)
    assert _rel(got, np.asarray(jr) + 1j * np.asarray(ji)) < 1e-5
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("n", SIZES)
def test_irfft2_matches_jax_and_torch_fft(rng, n):
    spec = np.fft.rfft(rng.normal(size=(3, n)))
    sr = spec.real.astype(np.float32)
    si = spec.imag.astype(np.float32)
    y = tfft.irfft2(torch.from_numpy(sr), torch.from_numpy(si), n).numpy()
    j = np.asarray(jfft.irfft2(jnp.asarray(sr), jnp.asarray(si), n))
    ref = torch.fft.irfft(torch.from_numpy(spec), n).numpy()
    assert y.shape == (3, n)
    assert _rel(y, j) < 1e-5
    assert _rel(y, ref) < 1e-5


def test_rfft2_pads_and_irfft2_checks_bins(rng):
    x = rng.normal(size=(2, 100)).astype(np.float32)
    yr, yi = tfft.rfft2(torch.from_numpy(x), 128)
    jr, ji = jfft.rfft2(jnp.asarray(x), 128)
    assert _rel(yr.numpy(), np.asarray(jr)) < 1e-5
    assert _rel(yi.numpy(), np.asarray(ji)) < 1e-5
    with pytest.raises(ValueError, match="65 bins"):
        tfft.irfft2(yr[..., :-1], yi[..., :-1], 128)


def test_rfft_untangle_constants_equal():
    for a, b in zip(tfft._rfft_untangle(256), jfft._rfft_untangle(256)):
        np.testing.assert_array_equal(a, np.asarray(b))
