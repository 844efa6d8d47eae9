"""The overlap-save frame kernel: wrapper around csrc/fused_frames.cu.

Replaces the TPU kernel ``totton_tpu/experimental/pallas_kernels.py``
(``_fused_kernel``, :284-317, launched by ``pl.pallas_call`` at :355) and
keeps its contract: ``fused_upsample_frames(frames [N, m] f32, bundle,
cfg) -> [N, block_size] f32``, the overlap region never stored, the
even/odd interleave written in place.

Design for an H100: every DFT is a batch of short Stockham FFTs in
shared memory (the .cu header has the algebra). ``kernel_plan`` picks one
of two plans from the geometry alone:

- resident (h = fft_size/2 <= ``RESIDENT_MAX_H``: ratio 1 and the 8k
  bank): one launch, the whole frame in one block's shared memory, as the
  Pallas kernel held it in VMEM; no scratch, so device memory sees each
  frame read once and each block written once;
- three launches (the 80k bank, whose h-point inverse does not fit a
  block): the forward in one launch where m <= ``FUSED_MAX`` (one m/2
  point FFT of the packed real frame, untangled as it is stored), else
  two; then I1 (the filter formed from the folded G as the loader reads
  X, P2-point FFTs and the twiddle) and I2 (Q2-point FFTs, the kept
  columns stored interleaved), through X and C scratch in device memory.

What bounds it is bytes, not FLOPs: at 16x/80k a frame needs 4.7 MFLOP
(``flops_per_frame``) against about 1.4 MB of scratch traffic. fp32 only;
TF32 is never used (the signal path is gated at > 125 dB).

Rules: a CPU tensor runs the plain version (``overlap_save.upsample_frames``);
a CUDA tensor runs the kernel or raises. ``LAUNCHES`` counts kernel calls.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from totton_tpu_torch.ops import _build
from totton_tpu_torch.ops import fft as _fft
from totton_tpu_torch.ops.overlap_save import (
    FoldedBundle,
    OverlapSaveConfig,
    upsample_frames,
)

#: Number of times the CUDA kernel was launched (one per wrapper call on a
#: CUDA tensor). Reset it to 0 to count the launches of one run.
LAUNCHES = 0

#: The resident plan's envelope (the .cu's ``kResidentMinH``,
#: ``kResidentMaxH``, ``kResidentMaxRatio``): h = fft_size/2 in [256, 8192]
#: at ratio <= 16 (the CLIs' ratios). The largest frame, 2x/8k, takes 108 KB
#: of a block's 227 KB of shared memory.
RESIDENT_MIN_H, RESIDENT_MAX_H, RESIDENT_MAX_RATIO = 256, 8192, 16
#: Largest frame whose forward transform runs in one launch, as one
#: m/2-point complex FFT per block (the .cu's ``dispatch<8192>``: 64 KB of
#: shared memory); larger frames take the two-launch four-step forward.
FUSED_MAX = 16384
#: Stage lengths the .cu instantiates for the four-step launches.
STAGE_MIN, STAGE_MAX = 16, 512


def _two_stage(n: int) -> tuple[int, int] | None:
    """(P, Q) split of a power-of-two n for a four-step transform: the
    plain path's factorization where it has two stages, a balanced
    power-of-two split where one DFT stage would do (n <= 512); any split
    computes the same DFT."""
    factors = _fft._factorize(n)
    if len(factors) == 2:
        return factors
    if len(factors) == 1 and n >= 4:
        p = 1 << (n.bit_length() // 2)
        return p, n // p
    return None


def _in_stage_range(*sizes: int) -> bool:
    return all(STAGE_MIN <= s <= STAGE_MAX for s in sizes)


@functools.lru_cache(maxsize=64)
def kernel_plan(cfg: OverlapSaveConfig) -> dict:
    """Static sizes the kernel runs with for ``cfg`` (every ratio, even
    overlap). ``resident`` (h <= RESIDENT_MAX_H): one launch, m, h, j0,
    the block. Else the three-launch plan: the forward (``fused``: one
    m/2-point FFT per frame, else the (P, Q) four-step), the inverse split
    h = P2 * Q2 (the plain folded path's balanced one: its I1 tile reads
    128-byte rows at h = 65536), j0 and the first kept stage-2 column
    k2_0. At ratio 1 (``halves``) Z sums the spectrum's two halves."""
    if cfg.overlap % 2 != 0:
        # (Odd overlaps exist only at ratio 1: (taps - 1) % ratio == 0.)
        raise NotImplementedError(
            "odd overlap (even tap count) runs the classic program, not the "
            "frame kernel (as in the JAX package)")
    m = cfg.frame_in
    h = cfg.fft_size // 2
    j0 = cfg.overlap // 2
    if (RESIDENT_MIN_H <= h <= RESIDENT_MAX_H
            and cfg.ratio <= RESIDENT_MAX_RATIO):
        # v: values a thread a pass (the .cu's Resident<M, H>::V).
        return dict(m=m, h=h, j0=j0, block=cfg.block_size, resident=True,
                    halves=cfg.ratio == 1, v=16 if h >= 4096 else 8)
    fused = 2 * STAGE_MIN <= m <= FUSED_MAX
    fwd = _two_stage(m)
    if not fused and (fwd is None or not _in_stage_range(*fwd)):
        raise NotImplementedError(f"frame_in {m} outside the kernel's range")
    p, q = fwd if fwd is not None else (m, 1)
    split = _two_stage(h)
    if split is None or not _in_stage_range(*split):
        raise NotImplementedError(f"fft_size {cfg.fft_size} outside the "
                                  "kernel's range")
    p2, q2 = split
    k2_0 = j0 // p2
    return dict(m=m, P=p, Q=q, h=h, P2=p2, Q2=q2, kept=q2 - k2_0,
                k2_0=k2_0, j0=j0, block=cfg.block_size, resident=False,
                fused=fused, halves=cfg.ratio == 1)


@functools.lru_cache(maxsize=32)
def _fwd_table(n: int):
    """W_n^e = exp(-2 pi i e / n), e = 0 .. n-1: angles in float64 with the
    exact (e mod n) reduction, stored float32 (an inverse stage multiplies
    by the conjugate)."""
    ang = -2.0 * np.pi * np.arange(n) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _pass_table(n: int, v: int = 8):
    """The resident kernel's twiddles for an n-point FFT at ``v`` values a
    thread (the .cu's PassTables): for each pass of ``fft_passes``
    (``_radices``) with NS > 1, in pass order, its [R - 1, NS] block
    W_{NS R}^{k r}, r = 1 .. R-1, k < NS; n - 8 entries. Angles in float64
    (the same floats as ``_fwd_table(n)`` at e = k r n/(NS R)), stored
    float32."""
    parts, ns = [], 1
    for r in _radices(n, v):
        if ns > 1:
            e = np.arange(1, r)[:, None] * np.arange(ns)[None, :]
            parts.append(-2.0 * np.pi * e.reshape(-1) / (ns * r))
        ns *= r
    ang = np.concatenate(parts)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _complex(builder, *args) -> tuple[np.ndarray]:
    """``builder(*args)``'s (re, im) pair as one [..., 2] float32 array
    (the kernel reads it as float2)."""
    re, im = builder(*args)
    return (np.ascontiguousarray(np.stack([re, im], -1), dtype=np.float32),)


@functools.lru_cache(maxsize=64)
def kernel_consts(cfg: OverlapSaveConfig, device) -> dict[str, torch.Tensor]:
    """The kernel's twiddle tables for ``cfg`` as [..., 2] float32 tensors
    on ``device``, built once per (cfg, device) and shared (read only).
    Resident: tw_fwd, the
    half-size FFT's ``_pass_table`` then W_m^j, j = 0 .. m/2, of the
    untangle; tw_inv, the inverse's ``_pass_table``. Three launches:
    tw_fwd, the forward W_{m/2}^e of the half-size FFT then W_m^j (fused),
    or W_P^e then W_Q^e; tw_m [P, Q] = W_m^{k1 q} (two-launch forward
    only); tw_p2 and tw_q2, the forward W_P2^e and W_Q2^e of the inverse
    stages; tw_h [Q2, P2] = W_h^{+k1' q2}."""
    pl = kernel_plan(cfg)

    def get(builder, *args):
        return _fft.device_consts(_complex, (builder, *args), device)[0]

    if pl["resident"] or pl["fused"]:
        half = pl["m"] // 2
        w_m = get(_fwd_table, pl["m"])[:half + 1]
        if pl["resident"]:
            return {"tw_fwd": torch.cat([get(_pass_table, half, pl["v"]),
                                         w_m]),
                    "tw_inv": get(_pass_table, pl["h"], pl["v"])}
        tw_fwd = torch.cat([get(_fwd_table, half), w_m])
    else:
        tw_fwd = torch.cat([get(_fwd_table, pl["P"]),
                            get(_fwd_table, pl["Q"])])
    out = {
        "tw_fwd": tw_fwd,
        "tw_p2": get(_fwd_table, pl["P2"]),
        "tw_q2": get(_fwd_table, pl["Q2"]),
        "tw_h": get(_fft._twiddle, pl["Q2"], pl["P2"], True),
    }
    if not pl["fused"]:
        out["tw_m"] = get(_fft._twiddle, pl["P"], pl["Q"], False)
    return out


#: Real FLOPs of one radix-R butterfly in registers (``dft<R>``: its adds
#: and, at radix 8, the two W_8 products; at radix 16, eight 4-point DFTs
#: and the W_16 products, 40), and of one complex product.
_BUTTERFLY_FLOPS = {2: 4, 4: 16, 8: 56, 16: 168}
_CMUL_FLOPS = 6


def _radices(length: int, v: int = 8) -> list[int]:
    """The radix of each pass of ``fft_passes`` for ``length`` points and
    ``v`` values a thread: 8 while 8 more points remain, then 2 or 4; at
    v = 16 a last 16 is one radix-16 pass."""
    out, ns = [], 1
    while ns < length:
        rest = length // ns
        out.append(16 if v == 16 and rest == 16 else min(8, rest))
        ns *= out[-1]
    return out


def _fft_flops(length: int, v: int = 8) -> int:
    """Real FLOPs of one ``length``-point FFT as ``fft_passes`` runs it
    (``_radices``); every butterfly after the first pass also takes R - 1
    twiddle products."""
    flops = 0
    for i, r in enumerate(_radices(length, v)):
        twiddles = (r - 1) * _CMUL_FLOPS if i else 0
        flops += length // r * (_BUTTERFLY_FLOPS[r] + twiddles)
    return flops


def flops_per_launch(cfg: OverlapSaveConfig) -> dict[str, int]:
    """Real FLOPs per frame that each launch needs, keyed R (the resident
    plan's one launch), or F (fused forward) or F1 and F2, then I1 and
    I2: the radix passes of its FFTs (``_fft_flops``), a four-step split's
    inter-stage twiddle (one complex product a point), the filter (one
    complex product a bin; ratio 1: two and an add, 14). The m/2-point
    forward's untangle is counted once for each of the m/2 + 1 bins it
    determines (14 each). The two-launch forward runs the real frame as
    complex data, and is counted at half of that: what a real input
    needs."""
    pl = kernel_plan(cfg)
    m, h = pl["m"], pl["h"]
    filt = 14 * h if pl["halves"] else _CMUL_FLOPS * h
    v = pl.get("v", 8)
    half_fwd = _fft_flops(m // 2, v) + 14 * (m // 2 + 1)
    if pl["resident"]:
        return {"R": half_fwd + filt + _fft_flops(h, v)}
    if pl["fused"]:
        fwd = {"F": half_fwd}
    else:
        fwd = {"F1": (pl["Q"] * _fft_flops(pl["P"]) + _CMUL_FLOPS * m) // 2,
               "F2": pl["P"] * _fft_flops(pl["Q"]) // 2}
    return {**fwd,
            "I1": filt + pl["Q2"] * _fft_flops(pl["P2"]) + _CMUL_FLOPS * h,
            "I2": pl["P2"] * _fft_flops(pl["Q2"])}


def flops_per_frame(cfg: OverlapSaveConfig) -> int:
    """Real FLOPs the kernel's launches need per frame."""
    return sum(flops_per_launch(cfg).values())


def bytes_per_launch(cfg: OverlapSaveConfig) -> dict[str, int]:
    """Device-memory bytes each launch reads and writes per frame (the
    frames, the X, B and C scratch, the output; the filter G and the
    twiddle tables are shared by all frames and left out). The resident
    launch R reads the frame once and writes the block once."""
    pl = kernel_plan(cfg)
    m, h, block = pl["m"], pl["h"], pl["block"]
    if pl["resident"]:
        return {"R": 4 * m + 4 * block}
    if pl["fused"]:
        fwd = {"F": 4 * m + 8 * m}
    else:
        fwd = {"F1": 4 * m + 8 * m, "F2": 8 * m + 8 * m}
    return {**fwd, "I1": 8 * m + 8 * h, "I2": 8 * h + 4 * block}


def bound_bytes(cfg: OverlapSaveConfig, n_frames: int) -> int:
    """The least bytes a dispatch of ``n_frames`` must move: each frame
    read once, each output block written once, the filter G and the
    twiddle tables read once."""
    pl = kernel_plan(cfg)
    consts = sum(v.numel() * 4 for v in kernel_consts(cfg, "cpu").values())
    g = 8 * pl["h"] * (2 if pl["halves"] else 1)
    return n_frames * 4 * (pl["m"] + pl["block"]) + g + consts


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the kernel library's C interface on ``lib``."""
    if lib.totton_fused_frames.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.totton_fused_frames.argtypes = [vp] * 11 + [i64] + [i32] * 10 + [
            vp]
        lib.totton_fused_frames.restype = i32
        lib.totton_resident_frames.argtypes = [vp] * 5 + [i64] + [i32] * 6 + [
            vp]
        lib.totton_resident_frames.restype = i32
        lib.totton_cuda_error_string.argtypes = [i32]
        lib.totton_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    return _bind(_build.load("fused_frames"))


def _launch(lib: ctypes.CDLL, frames: torch.Tensor, g: torch.Tensor,
            cfg: OverlapSaveConfig, stream) -> torch.Tensor:
    """The plan's launches for checked, contiguous frames [n > 0, m] and
    the folded G on their device, on ``stream`` of that device (the C
    entry makes it current): one (resident), else three or four through
    X, C (and B) scratch allocated here."""
    global LAUNCHES
    pl = kernel_plan(cfg)
    dev = frames.device
    n = frames.shape[0]
    out = torch.empty((n, pl["block"]), dtype=torch.float32, device=dev)
    consts = kernel_consts(cfg, dev)
    index = dev.index or 0
    if pl["resident"]:
        rc = lib.totton_resident_frames(
            frames.data_ptr(), out.data_ptr(), g.data_ptr(),
            consts["tw_fwd"].data_ptr(), consts["tw_inv"].data_ptr(), n,
            pl["m"], pl["h"], pl["block"], pl["j0"], int(pl["halves"]),
            index, stream)
    else:
        scratch_x = torch.empty((n, pl["m"], 2), dtype=torch.float32,
                                device=dev)
        scratch_b = (None if pl["fused"] else torch.empty_like(scratch_x))
        scratch_c = torch.empty((n, pl["h"], 2), dtype=torch.float32,
                                device=dev)
        rc = lib.totton_fused_frames(
            frames.data_ptr(), out.data_ptr(),
            0 if scratch_b is None else scratch_b.data_ptr(),
            scratch_x.data_ptr(), scratch_c.data_ptr(), g.data_ptr(),
            consts["tw_fwd"].data_ptr(),
            consts["tw_m"].data_ptr() if "tw_m" in consts else 0,
            consts["tw_p2"].data_ptr(), consts["tw_q2"].data_ptr(),
            consts["tw_h"].data_ptr(), n,
            pl["m"], pl["P"], pl["Q"], pl["P2"], pl["Q2"], pl["block"],
            pl["j0"], int(pl["fused"]), int(pl["halves"]), index, stream)
    if rc != 0:
        msg = lib.totton_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_frames launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return out


def _launch_cuda(frames: torch.Tensor, bundle: FoldedBundle,
                 cfg: OverlapSaveConfig) -> torch.Tensor:
    pl = kernel_plan(cfg)
    dev = frames.device
    n = frames.shape[0]
    _build.check_tensor(frames, "frames", dev, (n, pl["m"]))
    if bundle.absorbed or bundle.classic:
        raise ValueError("the kernel takes the folded filter G: fold the "
                         "bundle on the CUDA device (fold_bundle)")
    g = bundle.weights
    _build.check_tensor(g, "bundle.weights", dev,
           (2, pl["h"], 2) if pl["halves"] else (pl["h"], 2))
    if n == 0:
        return torch.empty((0, pl["block"]), dtype=torch.float32, device=dev)
    # The launch goes to the frames' card and its current stream: a kernel
    # launched on another card's stream fails (a mesh's cells span cards).
    # The C entry makes the card current; the raw stream handle, because
    # torch.cuda.current_stream(dev) and a device guard cost as much host
    # time a dispatch as the rest of the wrapper.
    return _launch(_lib(), frames, g, cfg,
                   torch._C._cuda_getCurrentRawStream(dev.index))


def fused_upsample_frames(frames: torch.Tensor, bundle: FoldedBundle,
                          cfg: OverlapSaveConfig) -> torch.Tensor:
    """[N, frame_in] frames -> [N, block_size] blocks. CUDA tensors run the
    hand-written kernel (or raise); CPU tensors run the plain version."""
    if frames.device.type == "cpu":
        return upsample_frames(frames, bundle, cfg)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    return _launch_cuda(frames, bundle, cfg)


def fused_upsample_blocks(x: torch.Tensor, bundle: FoldedBundle,
                          cfg: OverlapSaveConfig) -> torch.Tensor:
    """x: [..., halo_in + B*block_in] -> [..., B*block_size] through
    ``fused_upsample_frames``."""
    from totton_tpu_torch.ops.overlap_save import frame_input

    frames = frame_input(x, cfg.block_in, cfg.halo_in)
    lead = frames.shape[:-1]
    y = fused_upsample_frames(
        frames.reshape(-1, cfg.frame_in).contiguous(), bundle, cfg)
    return y.reshape(lead[:-1] + (-1,))
