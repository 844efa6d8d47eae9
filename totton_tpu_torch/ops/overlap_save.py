"""Overlap-save FIR upsampling in torch: the plain counterpart of
``totton_tpu.ops.overlap_save``.

The algebra is the JAX package's (see that module's docstrings for the
derivations): the zero-stuffed spectrum is the periodic tiling of the
input-rate frame's DFT, the inverse-real-FFT untangle and the filter
multiply collapse into Z = E*G, and a pruned half-size inverse emits the
even/odd interleaved output block without ever computing the overlap
region.

Three frame programs, chosen by the bundle (``fold_bundle``):

- **absorbed** (ratio >= 4, off the CUDA device): tiling, filter and
  inverse stage 1 collapse into one weight tensor GW[k1, s, q]
  (``_absorbed_stacked``); stage 2 is pruned and writes the interleave
  directly.
- **folded** (every even overlap; the only form on a CUDA device, where
  the kernel takes G): Z = tile(X)*G, then ``_pruned_half_inverse``.
- **classic** (odd overlap, i.e. an even tap count at ratio 1): rfft,
  periodic extension, times the spectrum, irfft, discard the overlap
  (``_upsample_frames_classic``).

Unlike the JAX package, the spectrum fold runs once per filter or EQ swap
(``fold_bundle``), not once per dispatch: the step takes
``(tail, x, bundle)``.

``upsample_frames`` here is the plain version. The main path calls
``ops.fused_frames.fused_upsample_frames``, which runs the hand-written
CUDA kernel on a CUDA tensor and this plain version on a CPU tensor; the
classic program is plain torch on every device, as the JAX package's
Pallas kernel never took it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from totton_tpu_torch.ops import fft as _fft


@dataclasses.dataclass(frozen=True)
class OverlapSaveConfig:
    """Static geometry of one overlap-save convolver.

    Invariants mirror the sidecar contract (docs/filter_format.md):
    fft_size power of two, fft_size - block_size == taps - 1,
    block_size % ratio == 0, and (taps - 1) % ratio == 0.
    """

    taps: int
    fft_size: int
    block_size: int
    ratio: int

    def __post_init__(self) -> None:
        if self.fft_size & (self.fft_size - 1):
            raise ValueError(f"fft_size must be a power of two: {self.fft_size}")
        if self.fft_size - self.block_size != self.taps - 1:
            raise ValueError(
                f"overlap-save invariant violated: {self.fft_size} - "
                f"{self.block_size} != {self.taps} - 1"
            )
        if self.ratio < 1 or (self.ratio & (self.ratio - 1)):
            raise ValueError(f"ratio must be a power of two >= 1: {self.ratio}")
        if self.block_size % self.ratio != 0:
            raise ValueError("block_size must be divisible by ratio")
        if (self.taps - 1) % self.ratio != 0:
            raise ValueError("(taps - 1) must be divisible by ratio")
        if self.ratio > 1 and (self.fft_size // self.ratio) % 2 != 0:
            raise ValueError("fft_size / ratio must be even")

    @classmethod
    def from_sidecar(cls, sidecar) -> "OverlapSaveConfig":
        return cls(
            taps=sidecar.taps,
            fft_size=sidecar.fft_size,
            block_size=sidecar.block_size,
            ratio=sidecar.upsample_factor,
        )

    @property
    def overlap(self) -> int:
        """History carried between blocks, in output-rate samples."""
        return self.taps - 1

    @property
    def frame_in(self) -> int:
        """Input-rate samples entering each FFT frame (= fft_size / ratio)."""
        return self.fft_size // self.ratio

    @property
    def block_in(self) -> int:
        """Fresh input-rate samples consumed per block."""
        return self.block_size // self.ratio

    @property
    def halo_in(self) -> int:
        """Input-rate history samples each block needs (= (taps-1) / ratio)."""
        return (self.taps - 1) // self.ratio

    @property
    def n_bins(self) -> int:
        """rfft bins at the output rate."""
        return self.fft_size // 2 + 1


def filter_spectrum(
    taps: np.ndarray,
    fft_size: int,
    eq_response: np.ndarray | None = None,
    device: str | torch.device = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The filter's rfft spectrum, optionally with EQ baked in, as a float32
    (re, im) pair on ``device``. Computed in float64 on the host (numpy) and
    cast once, exactly as the JAX package does."""
    h = np.asarray(taps, dtype=np.float64)
    if len(h) > fft_size:
        raise ValueError(f"taps ({len(h)}) longer than fft_size ({fft_size})")
    spectrum = np.fft.rfft(h, fft_size)
    if eq_response is not None:
        eq_response = np.asarray(eq_response)
        if eq_response.shape != spectrum.shape:
            raise ValueError(
                f"eq_response shape {eq_response.shape} != rfft bins "
                f"{spectrum.shape}"
            )
        spectrum = spectrum * eq_response
    return (
        torch.as_tensor(spectrum.real.astype(np.float32), device=device),
        torch.as_tensor(spectrum.imag.astype(np.float32), device=device),
    )


def zero_stuff(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """Insert ratio-1 zeros after each sample along the last axis (sample i
    lands at position i*ratio). For tests and oracles only."""
    if ratio == 1:
        return x
    out = torch.zeros(x.shape + (ratio,), dtype=x.dtype, device=x.device)
    out[..., 0] = x
    return out.reshape(x.shape[:-1] + (x.shape[-1] * ratio,))


def frame_input(x: torch.Tensor, block_in: int, halo_in: int) -> torch.Tensor:
    """Frame [..., halo_in + B*block_in] -> [..., B, halo_in + block_in]:
    frames[i] = x[i*block_in : i*block_in + halo_in + block_in] (a strided
    view; no copy)."""
    n = x.shape[-1]
    if (n - halo_in) % block_in != 0:
        raise ValueError(
            f"input length {n} minus halo {halo_in} must be a multiple of "
            f"block_in {block_in}"
        )
    return x.unfold(-1, halo_in + block_in, block_in)


def _fold_g(spectrum, fft_size: int):
    """Fold the rfft filter spectrum [h+1] pair into the G1/G2 pairs of the
    reversal-free formulation, with the inverse's 1/h folded in."""
    hr, hi = spectrum
    h = fft_size // 2
    k = np.arange(h)
    w = np.exp(-2j * np.pi * k / fft_size)
    a = 0.5 * (1.0 - 1j * w)
    b = 0.5 * (1.0 + 1j * w)
    dev = hr.device
    ca_r, ca_i, cb_r, cb_i = (
        torch.as_tensor(v.astype(np.float32), device=dev)
        for v in (a.real, -a.imag, b.real, -b.imag))  # conj(A), conj(B)
    h_r, h_i = hr[:h], hi[:h]
    hrev_r = torch.flip(hr[1:], (0,))      # H[h-k], k = 0..h-1
    hrev_i = -torch.flip(hi[1:], (0,))     # conj
    inv_h = np.float32(1.0 / h)
    g1 = ((ca_r * h_r - ca_i * h_i) * inv_h,
          (ca_r * h_i + ca_i * h_r) * inv_h)
    g2 = ((cb_r * hrev_r - cb_i * hrev_i) * inv_h,
          (cb_r * hrev_i + cb_i * hrev_r) * inv_h)
    return g1, g2


def _periodic_rfft_extend(sr: torch.Tensor, si: torch.Tensor, ratio: int):
    """Extend rfft(frame, M) to the rfft grid of the zero-stuffed length
    r*M: U[k] = X[k mod M] for k in [0, r*M/2], the full period of X
    rebuilt from the rfft half by Hermitian symmetry."""
    if ratio == 1:
        return sr, si
    reps = ratio // 2
    batch = (1,) * (sr.ndim - 1)
    full_r = torch.cat([sr[..., :-1], torch.flip(sr[..., 1:], (-1,))], -1)
    full_i = torch.cat([si[..., :-1], -torch.flip(si[..., 1:], (-1,))], -1)
    out_r = torch.cat([full_r.repeat(batch + (reps,)), sr[..., :1]], -1)
    out_i = torch.cat([full_i.repeat(batch + (reps,)), si[..., :1]], -1)
    return out_r, out_i


def absorbed_plan(cfg: OverlapSaveConfig) -> tuple[int, int, int, int] | None:
    """(P2, Q2, r_m, t_reps) of the tile-absorbed inverse, or None when the
    geometry takes the folded path (ratio < 4: at 2x the weight grows to
    h*r_m values with nothing to absorb).

    The inverse split h = P2*Q2 is the power-of-two split with the fewest
    complex multiply-adds per frame: h*r_m in stage 1 (r_m = m/Q2) plus
    P2*Q2*kept in the pruned stage 2 (kept = Q2 - j0//P2). At 16x/80k that
    is (512, 128): 1334 FLOP per output sample against 1519 for the
    balanced (256, 256). The algebra needs Q2 | m (then r_m | P2 since
    P2/r_m = ratio/2)."""
    if cfg.overlap % 2 != 0 or cfg.ratio < 4:
        return None
    m = cfg.frame_in
    h = cfg.fft_size // 2
    j0 = cfg.overlap // 2
    best = None
    q2 = 8
    while q2 <= h // 8:
        if m % q2 == 0:
            p2 = h // q2
            macs = h * (m // q2) + p2 * q2 * (q2 - j0 // p2)
            if best is None or macs < best[0]:
                best = (macs, p2, q2)
        q2 *= 2
    if best is None:
        return None
    _, p2, q2 = best
    r_m = m // q2
    return p2, q2, r_m, p2 // r_m


@functools.lru_cache(maxsize=64)
def _absorbed_consts(m: int, h: int, q2: int):
    """Host constants of the tile-absorbed inverse (numpy float32):
    Wt[k1, t, s] = exp(+2pi i (t*r_m + s) k1 / P2) and
    Wh[k1, q] = exp(+2pi i k1 q / h), as (re, im) each."""
    p2 = h // q2
    r_m = m // q2
    t_reps = p2 // r_m
    k1 = np.arange(p2)[:, None, None]
    tt = np.arange(t_reps)[None, :, None]
    ss = np.arange(r_m)[None, None, :]
    ang = 2.0 * np.pi * (((tt * r_m + ss) * k1) % p2) / p2
    kk, qq = np.meshgrid(np.arange(p2), np.arange(q2), indexing="ij")
    ang_h = 2.0 * np.pi * ((kk * qq) % h) / h
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32),
            np.cos(ang_h).astype(np.float32), np.sin(ang_h).astype(np.float32))


@functools.lru_cache(maxsize=64)
def _stage2_matrix(q2: int, p2: int, k2_0: int):
    """Pruned stage-2 DFT matrix W_{Q2}^{+q k2}, columns k2 >= k2_0."""
    qq, kk = np.meshgrid(np.arange(q2), np.arange(k2_0, q2), indexing="ij")
    ang = 2.0 * np.pi * ((qq * kk) % q2) / q2
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _stage2_matrix_stacked(q2: int, p2: int, k2_0: int):
    """Stage-2 weights W2S[q, r, m, e] with the even/odd interleave and the
    (cr, ci) pair folded in: out[..., m, k, e] =
    einsum('...kqr,qrme->...mke', c, W2S)."""
    w2_r, w2_i = _stage2_matrix(q2, p2, k2_0)
    a = np.stack([w2_r, w2_i], axis=-1)
    b = np.stack([-w2_i, w2_r], axis=-1)
    return (np.ascontiguousarray(np.stack([a, b], axis=1)),)


@dataclasses.dataclass(frozen=True)
class FoldedBundle:
    """The filter spectrum folded for one geometry, on one device; built
    once per filter or EQ swap by ``fold_bundle``.

    ``weights`` (float32, last axis = (re, im)):
      absorbed: GW laid out [Q2, r_m, P2, 2] (the plain path only);
      folded, ratio >= 2: G = G1 + G2, [h, 2];
      folded, ratio 1: G1 and G2 stacked, [2, h, 2];
      classic (odd overlap, ``classic``): the rfft spectrum itself,
        [n_bins, 2].
    """

    absorbed: bool
    weights: torch.Tensor
    classic: bool = False


def _folded_g(spectrum, cfg: OverlapSaveConfig) -> FoldedBundle:
    """The folded G bundle (valid at every ratio): G = G1 + G2 [h, 2], or
    G1 and G2 stacked [2, h, 2] at ratio 1."""
    (g1r, g1i), (g2r, g2i) = _fold_g(spectrum, cfg.fft_size)
    if cfg.ratio == 1:
        w = torch.stack([torch.stack([g1r, g1i], -1),
                         torch.stack([g2r, g2i], -1)])
    else:
        w = torch.stack([g1r + g2r, g1i + g2i], -1)
    return FoldedBundle(False, w.contiguous())


def fold_bundle(spectrum, cfg: OverlapSaveConfig) -> FoldedBundle:
    """Fold an rfft filter spectrum (re, im) pair into the frame program's
    weights (the work the JAX step repeats on every dispatch,
    totton_tpu/ops/overlap_save.py:599-616). An odd overlap's classic
    program takes the spectrum as it is.

    On a CUDA device the bundle is the folded G at every ratio: the kernel
    reads h bins, not the 32 MB GW at 16x/80k. Elsewhere it is GW where
    the geometry has an absorbed plan (ratio >= 4), as in the JAX
    package."""
    if cfg.overlap % 2 != 0:
        w = torch.stack([spectrum[0], spectrum[1]], -1)
        return FoldedBundle(False, w.contiguous(), classic=True)
    plan = (None if spectrum[0].device.type == "cuda"
            else absorbed_plan(cfg))
    if plan is None:
        return _folded_g(spectrum, cfg)
    (g1r, g1i), (g2r, g2i) = _fold_g(spectrum, cfg.fft_size)
    p2, q2, r_m, t_reps = plan
    dev = g1r.device
    wt_r, wt_i, wh_r, wh_i = _fft.device_consts(
        _absorbed_consts, (cfg.frame_in, cfg.fft_size // 2, q2), dev)
    # Ratio >= 2: the two folded terms share E, so G = G1 + G2.
    gr = (g1r + g2r).reshape(t_reps, r_m, q2)
    gi = (g1i + g2i).reshape(t_reps, r_m, q2)
    # GW0[k1, s, q] = sum_t G[(t r_m + s) Q2 + q] W_P2^{+(t r_m + s) k1}
    gw0_r = (torch.einsum("tsq,kts->ksq", gr, wt_r)
             - torch.einsum("tsq,kts->ksq", gi, wt_i))
    gw0_i = (torch.einsum("tsq,kts->ksq", gr, wt_i)
             + torch.einsum("tsq,kts->ksq", gi, wt_r))
    # Inter-stage twiddle folded in: GW = GW0 * W_h^{+k1 q}.
    gw_r = gw0_r * wh_r[:, None, :] - gw0_i * wh_i[:, None, :]
    gw_i = gw0_r * wh_i[:, None, :] + gw0_i * wh_r[:, None, :]
    gw = torch.stack([gw_r, gw_i], -1).permute(2, 1, 0, 3)  # [q, s, k, 2]
    return FoldedBundle(True, gw.contiguous())


def fold_bundles(taps: np.ndarray, cfg: OverlapSaveConfig,
                 eq_response: np.ndarray | None,
                 devices: list[torch.device]) -> dict:
    """{device: FoldedBundle} for every distinct device in ``devices``:
    one host spectrum of ``taps`` (+ EQ), folded once on each device (a
    mesh's cells, or a row split's groups)."""
    spectrum = filter_spectrum(taps, cfg.fft_size, eq_response)
    bundles = {}
    for dev in devices:
        if dev not in bundles:
            bundles[dev] = fold_bundle(tuple(s.to(dev) for s in spectrum),
                                       cfg)
    return bundles


def _pruned_half_inverse(zr, zi, h: int, j0: int):
    """Unnormalized inverse complex DFT of length h computing only the
    output tail j >= (j0 // P2) * P2 for a two-stage h (whole stage-2
    columns of the discarded overlap region are never computed). Returns
    (tr, ti, rem) with rem leading samples for the caller to trim."""
    factors = _fft._factorize(h)
    if len(factors) != 2:
        tr, ti = _fft._fft_rec(zr, zi, factors, inverse=True)
        return tr[..., j0:], ti[..., j0:], 0
    p2, q2 = factors
    dev = zr.device
    wr, wi = _fft.device_consts(_fft._dft_matrix, (p2, True), dev)
    ar = zr.reshape(zr.shape[:-1] + (p2, q2))
    ai = zi.reshape(zi.shape[:-1] + (p2, q2))
    sub = "...pq,pk->...kq"
    br = torch.einsum(sub, ar, wr) - torch.einsum(sub, ai, wi)
    bi = torch.einsum(sub, ar, wi) + torch.einsum(sub, ai, wr)
    tw_r, tw_i = _fft.device_consts(_fft._twiddle, (p2, q2, True), dev)
    cr, ci = _fft.complex_mul(br, bi, tw_r, tw_i)
    k2_0 = j0 // p2
    rem = j0 - k2_0 * p2
    w2_r, w2_i = _fft.device_consts(_stage2_matrix, (q2, p2, k2_0), dev)
    # Emit [..., k2', k1] so natural order j = k2*P2 + k1 is a reshape.
    dr = (torch.einsum("...kq,qm->...mk", cr, w2_r)
          - torch.einsum("...kq,qm->...mk", ci, w2_i))
    di = (torch.einsum("...kq,qm->...mk", cr, w2_i)
          + torch.einsum("...kq,qm->...mk", ci, w2_r))
    lead = zr.shape[:-1]
    return dr.reshape(lead + (-1,)), di.reshape(lead + (-1,)), rem


def _absorbed_stacked(frames, gw, cfg: OverlapSaveConfig, plan):
    """Forward DFT + inverse stage 1 (tile, filter and twiddle absorbed in
    GW) + pruned stage 2 with the interleave absorbed: the JAX package's
    stacked/stacked2 frame pipeline (ops/overlap_save.py:497-571)."""
    p2, q2, r_m, _ = plan
    m = cfg.frame_in
    lead = frames.shape[:-1]
    gr, gi = gw[..., 0], gw[..., 1]  # [q, s, k]
    m_factors = _fft._split_factors(m)
    if m_factors is not None and q2 % m_factors[0] == 0:
        # Stacked forward in its split layout: bin k2*P + k1 = s*Q2 + q
        # with s = k2 // w, q = (k2 % w)*P + k1 — GW re-indexed, no
        # transpose of the spectrum.
        d, p_f, _ = _fft.fft2_real_split_stacked(frames, m)
        w = q2 // p_f
        x2 = d.reshape(lead + (p_f, r_m, w, 2))            # [f, s, b, r]
        gbr = gr.reshape(w, p_f, r_m, p2)                    # [b, f, s, k]
        gbi = gi.reshape(w, p_f, r_m, p2)
        w1 = torch.stack([torch.stack([gbr, gbi], -1),
                          torch.stack([-gbi, gbr], -1)], -2)  # [b,f,s,k,rin,x]
        c = torch.einsum("...fsbr,bfskrx->...kbfx", x2, w1)
        c = c.reshape(lead + (p2, q2, 2))
    else:
        xr, xi = _fft.fft2_real(frames, m)
        x2 = torch.cat([xr.reshape(lead + (r_m, q2)),
                        xi.reshape(lead + (r_m, q2))], dim=-2)  # [2s, q]
        w1 = torch.stack([torch.cat([gr, -gi], dim=1),
                          torch.cat([gi, gr], dim=1)], -1)      # [q, 2s, k, r]
        c = torch.einsum("...zq,qzkr->...kqr", x2, w1)
    j0 = cfg.overlap // 2
    k2_0 = j0 // p2
    rem = j0 - k2_0 * p2
    (s2,) = _fft.device_consts(_stage2_matrix_stacked, (q2, p2, k2_0),
                               frames.device)
    out = torch.einsum("...kqr,qrme->...mke", c, s2).reshape(lead + (-1,))
    return out[..., 2 * rem: 2 * rem + cfg.block_size]


def upsample_frames(frames: torch.Tensor, bundle: FoldedBundle,
                    cfg: OverlapSaveConfig) -> torch.Tensor:
    """Plain version of the frame function:
    [..., frame_in] input-rate frames -> [..., block_size] output blocks.
    The bundle's form picks the program: absorbed (GW), folded (G, valid
    at every ratio) or, for odd overlaps, classic, as in the JAX
    package."""
    frames = frames.to(torch.float32)
    plan = absorbed_plan(cfg)
    if (bundle.classic != (cfg.overlap % 2 != 0)
            or (bundle.absorbed and plan is None)):
        raise ValueError("bundle was folded for another geometry")
    if bundle.classic:
        return _upsample_frames_classic(frames, bundle, cfg)
    if bundle.absorbed:
        return _absorbed_stacked(frames, bundle.weights, cfg, plan)
    m = cfg.frame_in
    h = cfg.fft_size // 2
    j0 = cfg.overlap // 2
    xr, xi = _fft.fft2_real(frames, m)
    g = bundle.weights
    if cfg.ratio >= 2:
        reps = h // m
        er = xr.repeat((1,) * (xr.ndim - 1) + (reps,)) if reps > 1 else xr
        ei = xi.repeat((1,) * (xi.ndim - 1) + (reps,)) if reps > 1 else xi
        zr, zi = _fft.complex_mul(er, ei, g[:, 0], g[:, 1])
    else:  # ratio 1: h = m // 2; the second term reads the upper half.
        g1, g2 = g[0], g[1]
        er, ei = xr[..., :h], xi[..., :h]
        e2r, e2i = xr[..., h:], xi[..., h:]
        zr = er * g1[:, 0] - ei * g1[:, 1] + e2r * g2[:, 0] - e2i * g2[:, 1]
        zi = er * g1[:, 1] + ei * g1[:, 0] + e2r * g2[:, 1] + e2i * g2[:, 0]
    tr, ti, rem = _pruned_half_inverse(zr, zi, h, j0)
    out = torch.stack([tr, ti], -1).reshape(frames.shape[:-1] + (-1,))
    return out[..., 2 * rem: 2 * rem + cfg.block_size]


def _upsample_frames_classic(frames: torch.Tensor, bundle: FoldedBundle,
                             cfg: OverlapSaveConfig) -> torch.Tensor:
    """rfft -> periodic extension -> x H -> irfft -> discard the overlap
    (the JAX package's odd-overlap program, ops/overlap_save.py:782-791)."""
    xr, xi = _fft.rfft2(frames, cfg.frame_in)
    er, ei = _periodic_rfft_extend(xr, xi, cfg.ratio)
    h = bundle.weights
    yr, yi = _fft.complex_mul(er, ei, h[:, 0], h[:, 1])
    return _fft.irfft2(yr, yi, cfg.fft_size)[..., cfg.overlap:]


def upsample_blocks(x: torch.Tensor, bundle: FoldedBundle,
                    cfg: OverlapSaveConfig) -> torch.Tensor:
    """Plain: upsample a contiguous input carrying its own history.

    x: [..., halo_in + B*block_in] float32 at the input rate; the first
    halo_in samples are history (zeros at stream start).
    Returns [..., B*block_size] float32 at the output rate.
    """
    frames = frame_input(x, cfg.block_in, cfg.halo_in)
    blocks = upsample_frames(frames, bundle, cfg)
    return blocks.reshape(x.shape[:-1] + (blocks.shape[-2] * cfg.block_size,))


def make_block_step(cfg: OverlapSaveConfig):
    """Streaming step: (tail, x, bundle) -> (y, new_tail).

    tail: [C, halo_in] carried input history; x: [C, B*block_in] fresh
    input; bundle: from ``fold_bundle`` (a hot swap passes another bundle
    and rebuilds nothing). Frames go through
    ``fused_frames.fused_upsample_frames``: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor. Odd overlaps run the
    classic program on every device (the JAX package's Pallas kernel never
    takes them either).
    """
    from totton_tpu_torch.ops.fused_frames import fused_upsample_blocks

    blocks = upsample_blocks if cfg.overlap % 2 else fused_upsample_blocks

    def step(tail: torch.Tensor, x: torch.Tensor, bundle: FoldedBundle):
        xin = torch.cat([tail, x], dim=-1)
        y = blocks(xin, bundle, cfg)
        return y, xin[..., xin.shape[-1] - cfg.halo_in:].clone()

    return step
