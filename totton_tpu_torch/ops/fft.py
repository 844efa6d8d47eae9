"""Matmul DFT in torch: the plain counterpart of ``totton_tpu.ops.fft``.

The host constant tables (numpy, float64 angles with the exact
``(j*k) % n`` reduction, cast to float32 — identical to the JAX
package's), the forward real transforms of the frame programs, and the
complex ``fft2``/``ifft2`` and real ``rfft2``/``irfft2`` (half-size
complex DFT plus untangle) that the classic odd-overlap program and the
crossfeed step share, all as fp32 ``torch.einsum`` (TF32 stays off).
Spectra are (re, im) float32 pairs, as in the reference.

For N = P * Q (x[n], n = Q*p + q): reshape to A[p, q], DFT over p, twiddle
by W_N^{k1 q}, DFT over q; the natural-order bin is k = k2*P + k1.

The CUDA frame kernel (ops/fused_frames.py) does not call these; it reads
the same constants through ``device_consts``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: Largest direct-DFT stage (same as the JAX package, so the plain path's
#: factorizations and rounding match the reference).
_MAX_RADIX = 512


def _factorize(n: int) -> tuple[int, ...]:
    """Balanced split into the fewest factors <= _MAX_RADIX."""
    if n == 0 or n & (n - 1):
        raise ValueError(f"FFT size must be a power of two, got {n}")
    factors = []
    while n > _MAX_RADIX:
        log = n.bit_length() - 1
        f = min(_MAX_RADIX, 1 << ((log + 1) // 2))
        factors.append(f)
        n //= f
    factors.append(n)
    return tuple(factors)


def _split_factors(n: int) -> tuple[int, int] | None:
    """Two-stage (P, Q) factorization, or None when n doesn't factorize
    into exactly two stages."""
    factors = _factorize(n)
    return factors if len(factors) == 2 else None


@functools.lru_cache(maxsize=128)
def _dft_matrix(n: int, inverse: bool) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) of the [n, n] DFT matrix W[j, k] = exp(-+2πi jk / n)."""
    j, k = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ang = (2.0 if inverse else -2.0) * np.pi * (j * k % n) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=128)
def _twiddle(p: int, q: int, inverse: bool) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) of the [p, q] twiddle W_N^{p q}, N = p*q."""
    n = p * q
    jj, kk = np.meshgrid(np.arange(p), np.arange(q), indexing="ij")
    ang = (2.0 if inverse else -2.0) * np.pi * (jj * kk % n) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _split_stacked_consts(p: int, q: int):
    """Host constants of the fully-stacked two-stage real forward DFT:
    W1[p, k1, r] and W2[k1, q, rin, k2, rout] (inter-stage twiddle folded
    into the stage-2 weights). Same values as the JAX package's."""
    w1r, w1i = _dft_matrix(p, False)
    w1 = np.stack([w1r, w1i], axis=-1)
    tw_r, tw_i = _twiddle(p, q, False)
    w2r, w2i = _dft_matrix(q, False)
    v_r = tw_r[:, :, None] * w2r[None, :, :] - tw_i[:, :, None] * w2i[None]
    v_i = tw_r[:, :, None] * w2i[None, :, :] + tw_i[:, :, None] * w2r[None]
    w2 = np.stack([
        np.stack([v_r, v_i], axis=-1),
        np.stack([-v_i, v_r], axis=-1),
    ], axis=2).astype(np.float32)
    return np.ascontiguousarray(w1), np.ascontiguousarray(w2)


@functools.lru_cache(maxsize=256)
def device_consts(builder, args: tuple, device: torch.device
                  ) -> tuple[torch.Tensor, ...]:
    """``builder(*args)``'s numpy constants as float32 tensors on
    ``device``, built and copied once per (builder, args, device)."""
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in builder(*args))


def complex_mul(ar, ai, br, bi):
    """Elementwise complex multiply on pairs."""
    return ar * br - ai * bi, ar * bi + ai * br


def _cmatmul(ar, ai, wr, wi):
    """[..., j] complex x [j, k] complex -> [..., k] via 4 real matmuls."""
    rr = torch.einsum("...j,jk->...k", ar, wr)
    ii = torch.einsum("...j,jk->...k", ai, wi)
    ri = torch.einsum("...j,jk->...k", ar, wi)
    ir = torch.einsum("...j,jk->...k", ai, wr)
    return rr - ii, ri + ir


def _fft_rec(xr, xi, factors, inverse):
    """Unnormalized complex DFT along the last axis; len = prod(factors)."""
    n = xr.shape[-1]
    p = factors[0]
    wr, wi = device_consts(_dft_matrix, (p, inverse), xr.device)
    if len(factors) == 1:
        return _cmatmul(xr, xi, wr, wi)
    q = n // p
    ar = xr.reshape(xr.shape[:-1] + (p, q))
    ai = xi.reshape(xi.shape[:-1] + (p, q))
    brr = torch.einsum("...pq,pk->...kq", ar, wr)
    bii = torch.einsum("...pq,pk->...kq", ai, wi)
    bri = torch.einsum("...pq,pk->...kq", ar, wi)
    bir = torch.einsum("...pq,pk->...kq", ai, wr)
    br, bi = brr - bii, bri + bir
    tr, ti = device_consts(_twiddle, (p, q, inverse), xr.device)
    cr, ci = complex_mul(br, bi, tr, ti)
    dr, di = _fft_rec(cr, ci, factors[1:], inverse)  # [..., k1, k2]
    out_r = dr.transpose(-1, -2).reshape(xr.shape[:-1] + (n,))
    out_i = di.transpose(-1, -2).reshape(xr.shape[:-1] + (n,))
    return out_r, out_i


def _fft_rec_real(x, factors):
    """Unnormalized forward DFT of a REAL input along the last axis: the
    first stage needs only 2 real matmuls."""
    n = x.shape[-1]
    p = factors[0]
    wr, wi = device_consts(_dft_matrix, (p, False), x.device)
    if len(factors) == 1:
        return (torch.einsum("...j,jk->...k", x, wr),
                torch.einsum("...j,jk->...k", x, wi))
    q = n // p
    a = x.reshape(x.shape[:-1] + (p, q))
    br = torch.einsum("...pq,pk->...kq", a, wr)
    bi = torch.einsum("...pq,pk->...kq", a, wi)
    tr, ti = device_consts(_twiddle, (p, q, False), x.device)
    cr, ci = complex_mul(br, bi, tr, ti)
    dr, di = _fft_rec(cr, ci, factors[1:], False)
    out_r = dr.transpose(-1, -2).reshape(x.shape[:-1] + (n,))
    out_i = di.transpose(-1, -2).reshape(x.shape[:-1] + (n,))
    return out_r, out_i


def fft2_real(x: torch.Tensor, n: int | None = None):
    """Forward DFT of a real input -> full-length (re, im) pair."""
    if n is None:
        n = x.shape[-1]
    if x.shape[-1] != n:
        raise ValueError(f"fft2_real expects length {n}, got {x.shape[-1]}")
    x = x.to(torch.float32)
    if n == 1:
        return x, torch.zeros_like(x)
    return _fft_rec_real(x, _factorize(n))


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad or cut the last axis to n."""
    if x.shape[-1] < n:
        return torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    return x[..., :n]


def fft2(xr: torch.Tensor, xi: torch.Tensor, n: int | None = None):
    """Complex DFT on a (re, im) pair along the last axis."""
    if n is None:
        n = xr.shape[-1]
    xr = _pad_last(xr.to(torch.float32), n)
    xi = _pad_last(xi.to(torch.float32), n)
    if n == 1:
        return xr, xi
    return _fft_rec(xr, xi, _factorize(n), inverse=False)


def ifft2(xr: torch.Tensor, xi: torch.Tensor, n: int | None = None):
    """Inverse complex DFT on a pair (normalized by 1/n)."""
    if n is None:
        n = xr.shape[-1]
    xr = _pad_last(xr.to(torch.float32), n)
    xi = _pad_last(xi.to(torch.float32), n)
    if n == 1:
        return xr, xi
    yr, yi = _fft_rec(xr, xi, _factorize(n), inverse=True)
    s = np.float32(1.0 / n)
    return yr * s, yi * s


@functools.lru_cache(maxsize=128)
def _rfft_untangle(n: int):
    """(Ar, Ai, Br, Bi) untangling twiddles of the half-size real trick:
    for z[m] = x[2m] + i x[2m+1] and Z = fft(z, n/2),
    X[k] = A[k] Z[k] + B[k] conj(Z[(n/2 - k) mod n/2]), k = 0..n/2, with
    A[k] = (1 - i W_n^k)/2 and B[k] = (1 + i W_n^k)/2."""
    k = np.arange(n // 2 + 1)
    w = np.exp(-2j * np.pi * k / n)
    a = 0.5 * (1.0 - 1j * w)
    b = 0.5 * (1.0 + 1j * w)
    return tuple(v.astype(np.float32) for v in (a.real, a.imag, b.real,
                                                b.imag))


def rfft2(x: torch.Tensor, n: int | None = None):
    """Real DFT along the last axis -> (re, im) with n//2 + 1 bins (one
    complex DFT of n/2 on the (even, odd) pairs, then the untangle)."""
    if n is None:
        n = x.shape[-1]
    x = _pad_last(x.to(torch.float32), n)
    if n == 1:
        return x, torch.zeros_like(x)
    half = n // 2
    zr, zi = fft2(x[..., 0::2], x[..., 1::2], half)
    # Extend to half+1 bins (Z[half] = Z[0]) and build conj(Z[half - k]).
    zr_ext = torch.cat([zr, zr[..., :1]], dim=-1)
    zi_ext = torch.cat([zi, zi[..., :1]], dim=-1)
    zr_rev = torch.cat([zr[..., :1], torch.flip(zr[..., 1:], (-1,)),
                        zr[..., :1]], dim=-1)
    zi_rev = -torch.cat([zi[..., :1], torch.flip(zi[..., 1:], (-1,)),
                         zi[..., :1]], dim=-1)
    ar, ai, br, bi = device_consts(_rfft_untangle, (n,), x.device)
    t1r, t1i = complex_mul(zr_ext, zi_ext, ar, ai)
    t2r, t2i = complex_mul(zr_rev, zi_rev, br, bi)
    return t1r + t2r, t1i + t2i


def irfft2(xr: torch.Tensor, xi: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse real DFT of n//2 + 1 bins -> n real samples."""
    if xr.shape[-1] != n // 2 + 1:
        raise ValueError(
            f"irfft2 expects {n // 2 + 1} bins for n={n}, got {xr.shape[-1]}"
        )
    if n == 1:
        return xr[..., :1].to(torch.float32)
    half = n // 2
    ar, ai, br, bi = device_consts(_rfft_untangle, (n,), xr.device)
    # Invert the untangle: Z[k] = conj(A[k]) X[k] + conj(B[k]) conj(X[n/2-k]).
    xrr = torch.flip(xr, (-1,))
    xir = -torch.flip(xi, (-1,))
    t1r, t1i = complex_mul(xr, xi, ar, -ai)
    t2r, t2i = complex_mul(xrr, xir, br, -bi)
    zr = (t1r + t2r)[..., :half]
    zi = (t1i + t2i)[..., :half]
    yr, yi = ifft2(zr, zi, half)
    # Re-interleave even/odd: out[2m] = yr[m], out[2m+1] = yi[m].
    return torch.stack([yr, yi], dim=-1).reshape(xr.shape[:-1] + (n,))


def fft2_real_split_stacked(x: torch.Tensor, n: int):
    """Forward DFT of a real input for two-stage sizes, fully stacked: two
    einsums, returning d[..., k1, k2, r] with natural-order bin
    X[k2*P + k1] = d[..., k1, k2, 0] + i d[..., k1, k2, 1]. Returns
    (d, P, Q)."""
    factors = _split_factors(n)
    if factors is None:
        raise ValueError(f"fft2_real_split_stacked needs a two-stage size, "
                         f"got {n}")
    p, q = factors
    if x.shape[-1] != n:
        raise ValueError(f"expected length {n}, got {x.shape[-1]}")
    a = x.to(torch.float32).reshape(x.shape[:-1] + (p, q))
    w1, w2 = device_consts(_split_stacked_consts, (p, q), x.device)
    b = torch.einsum("...pq,pkr->...kqr", a, w1)
    return torch.einsum("...fqz,fqzkr->...fkr", b, w2), p, q
