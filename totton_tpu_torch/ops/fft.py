"""Matmul DFT in torch: the plain counterpart of ``totton_tpu.ops.fft``.

The host constant tables (numpy, float64 angles with the exact
``(j*k) % n`` reduction, cast to float32 — identical to the JAX
package's), the forward real transforms of the frame programs, and the
complex ``fft2``/``ifft2`` and real ``rfft2``/``irfft2`` (half-size
complex DFT plus untangle) that the classic odd-overlap program and the
crossfeed step share, all as fp32 matmuls (TF32 stays off). Spectra are
(re, im) float32 pairs, as in the reference.

Every product against a constant goes through ``frame_matmul``, with the
frames (channels x frames, flattened) on axis 0: a frame's output is the
same bits whatever the number of frames that share its dispatch, as in
the JAX package. The public transforms flatten the leading axes of their
input into that axis.

For N = P * Q (x[n], n = Q*p + q): reshape to A[p, q], DFT over p, twiddle
by W_N^{k1 q}, DFT over q; the natural-order bin is k = k2*P + k1.

The CUDA frame kernel (ops/fused_frames.py) does not call these; it reads
the same constants through ``device_consts``.
"""

from __future__ import annotations

import functools
import math

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


#: Frames each cuBLAS call of ``frame_matmul`` takes on a CUDA device.
#: cuBLAS picks its kernel, and with it the rounding, by the batch count
#: (``python3 chip_smoke.py --plain .`` prints what one ``torch.bmm`` of
#: a few frames gives against the same frames among 1024), so every call
#: there gets exactly this many frames, the last call's padded with
#: zeros: a 512-block stereo dispatch is four calls a product. Every
#: value from 8 to 256 gave the same bits; 256 is the fastest where the
#: card's time shows. Timed by ``--plain`` on an NVIDIA H100 80GB HBM3 at
#: 700 W: a 512-block dispatch of the crossfeed step took 5.04 ms of
#: device time at 256 against 5.31 at 128, 7.16 at 32 and 15.3 at 8 (the
#: classic program 1.16 against 1.36, 2.71, 8.2), while at 1-8 blocks,
#: a live period's, the padding added at most 0.2 ms of device time to
#: a step whose host time was 2-3.5 ms at every value.
CUDA_BATCH = 256


def frame_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The one contraction of the frame programs: x [F, ..., K] against a
    constant w [K, N] -> [F, ..., N].

    Axis 0 holds the frames. They are the batch of a ``torch.bmm``
    against ``w`` expanded with stride 0, and each frame's own rows are
    its M, so every frame goes through a product of one shape whatever
    the number of frames beside it: its bits do not depend on the size of
    its dispatch. One GEMM over frames x rows, as an einsum with ``...``
    gives, lets the BLAS choose its algorithm, and so its rounding, by
    the number of frames. On the CPU a frame of one row (a single-stage
    transform) gets a second row of zeros: with M = 1 the BLAS's bits
    still depend on the batch count. On a CUDA device the batch goes in
    calls of ``CUDA_BATCH`` frames."""
    f, (k, n) = x.shape[0], w.shape
    rows = math.prod(x.shape[1:-1])
    xb = x.reshape(f, rows, k)
    if x.device.type == "cuda":
        y = _cuda_bmm(xb, w.contiguous())
    elif rows == 1:
        xp = xb.new_zeros((f, 2, k))
        xp[:, :1] = xb
        y = torch.bmm(xp, w.expand(f, k, n))[:, :1]
    else:
        y = torch.bmm(xb, w.expand(f, k, n))
    return y.reshape(x.shape[:-1] + (n,))


def _cuda_bmm(xb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xb [F, rows, K] @ w [K, N] in calls of exactly CUDA_BATCH frames,
    each from a contiguous, zero-padded copy (so that every call has one
    shape and one layout)."""
    f, rows, k = xb.shape
    total = -(-f // CUDA_BATCH) * CUDA_BATCH
    xp = xb.new_zeros((total, rows, k))
    xp[:f] = xb
    y = xb.new_empty((total, rows, w.shape[1]))
    we = w.expand(CUDA_BATCH, k, w.shape[1])
    for lo in range(0, total, CUDA_BATCH):
        torch.bmm(xp[lo:lo + CUDA_BATCH], we, out=y[lo:lo + CUDA_BATCH])
    return y[:f]


def _dft_rows(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [F, ..., p, q] against w [p, k] over p -> [F, ..., k, q]."""
    return frame_matmul(a.transpose(-1, -2), w).transpose(-1, -2)


def _cmatmul(ar, ai, wr, wi, mm=frame_matmul):
    """Complex x against complex w via 4 real products ``mm``."""
    return mm(ar, wr) - mm(ai, wi), mm(ar, wi) + mm(ai, wr)


def _fft_rec(xr, xi, factors, inverse):
    """Unnormalized complex DFT along the last axis of [F, ..., n];
    n = prod(factors)."""
    n = xr.shape[-1]
    p = factors[0]
    wr, wi = device_consts(_dft_matrix, (p, inverse), xr.device)
    if len(factors) == 1:
        return _cmatmul(xr, xi, wr, wi)
    q = n // p
    ar = xr.reshape(xr.shape[:-1] + (p, q))
    ai = xi.reshape(xi.shape[:-1] + (p, q))
    br, bi = _cmatmul(ar, ai, wr, wi, _dft_rows)
    tr, ti = device_consts(_twiddle, (p, q, inverse), xr.device)
    cr, ci = complex_mul(br, bi, tr, ti)
    dr, di = _fft_rec(cr, ci, factors[1:], inverse)  # [..., k1, k2]
    out_r = dr.transpose(-1, -2).reshape(xr.shape[:-1] + (n,))
    out_i = di.transpose(-1, -2).reshape(xr.shape[:-1] + (n,))
    return out_r, out_i


def _fft_rec_real(x, factors):
    """Unnormalized forward DFT of a REAL [F, ..., n] along the last axis:
    the first stage needs only 2 real products."""
    n = x.shape[-1]
    p = factors[0]
    wr, wi = device_consts(_dft_matrix, (p, False), x.device)
    if len(factors) == 1:
        return frame_matmul(x, wr), frame_matmul(x, wi)
    q = n // p
    a = x.reshape(x.shape[:-1] + (p, q))
    br, bi = _dft_rows(a, wr), _dft_rows(a, wi)
    tr, ti = device_consts(_twiddle, (p, q, False), x.device)
    cr, ci = complex_mul(br, bi, tr, ti)
    dr, di = _fft_rec(cr, ci, factors[1:], False)
    out_r = dr.transpose(-1, -2).reshape(x.shape[:-1] + (n,))
    out_i = di.transpose(-1, -2).reshape(x.shape[:-1] + (n,))
    return out_r, out_i


def _frames(x: torch.Tensor, n: int) -> torch.Tensor:
    """[..., n] -> [F, n] float32, the leading axes flattened into F."""
    return x.to(torch.float32).reshape(-1, n)


def fft2_real(x: torch.Tensor, n: int | None = None):
    """Forward DFT of a real input -> full-length (re, im) pair."""
    if n is None:
        n = x.shape[-1]
    if x.shape[-1] != n:
        raise ValueError(f"fft2_real expects length {n}, got {x.shape[-1]}")
    x = x.to(torch.float32)
    if n == 1:
        return x, torch.zeros_like(x)
    yr, yi = _fft_rec_real(_frames(x, n), _factorize(n))
    return yr.reshape(x.shape), yi.reshape(x.shape)


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
    yr, yi = _fft_rec(_frames(xr, n), _frames(xi, n), _factorize(n),
                      inverse=False)
    return yr.reshape(xr.shape), yi.reshape(xr.shape)


def ifft2(xr: torch.Tensor, xi: torch.Tensor, n: int | None = None):
    """Inverse complex DFT on a pair (normalized by 1/n)."""
    if n is None:
        n = xr.shape[-1]
    xr = _pad_last(xr.to(torch.float32), n)
    xi = _pad_last(xi.to(torch.float32), n)
    if n == 1:
        return xr, xi
    yr, yi = _fft_rec(_frames(xr, n), _frames(xi, n), _factorize(n),
                      inverse=True)
    s = np.float32(1.0 / n)
    return yr.reshape(xr.shape) * s, yi.reshape(xr.shape) * s


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
