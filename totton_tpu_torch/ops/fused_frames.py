"""The overlap-save frame kernel: wrapper around csrc/fused_frames.cu.

Replaces the TPU kernel ``totton_tpu/experimental/pallas_kernels.py``
(``_fused_kernel``, :284-317, launched by ``pl.pallas_call`` at :355) and
keeps its contract: ``fused_upsample_frames(frames [N, m] f32, bundle,
cfg) -> [N, block_size] f32``, the overlap region never computed, the
even/odd interleave written in place.

What bounds it on an H100: fp32 FMA on the CUDA cores. The absorbed form
needs 1334 FLOP per output sample at 16x/80k (``flops_per_frame``), most
of it in the two inverse stages. One frame's half-size
inverse (512 KB at h = 65536) does not fit in a block's 227 KB of shared
memory, and the TPU kernel's one frame per program starved its matrix
unit, so the design splits each frame over four batched complex-GEMM
launches with many frames along every product's rows (the .cu header has
the algebra). TF32 is never used: the signal path is gated at > 125 dB.

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
    _stage2_matrix,
    absorbed_plan,
    upsample_frames,
)

#: Number of times the CUDA kernel was launched (one per wrapper call on a
#: CUDA tensor). Reset it to 0 to count the launches of one run.
LAUNCHES = 0


def _two_stage(n: int) -> tuple[int, int] | None:
    """(P, Q) split of a power-of-two n for the kernel's two GEMM stages:
    the plain path's factorization where it has two stages, a balanced
    power-of-two split where one DFT stage would do (n <= 512); any split
    computes the same DFT."""
    factors = _fft._factorize(n)
    if len(factors) == 2:
        return factors
    if len(factors) == 1 and n >= 4:
        p = 1 << (n.bit_length() // 2)
        return p, n // p
    return None


@functools.lru_cache(maxsize=64)
def kernel_plan(cfg: OverlapSaveConfig) -> dict:
    """Static sizes the kernel runs with for ``cfg`` (every ratio, even
    overlap). The splits may differ from the plain path's. At ratio 1
    (``halves``) I1 sums the spectrum's two halves: depth P2, X's row
    stride r = 2*P2."""
    if cfg.overlap % 2 != 0:
        # (Odd overlaps exist only at ratio 1: (taps - 1) % ratio == 0.)
        raise NotImplementedError(
            "odd overlap (even tap count) runs the classic program, not the "
            "frame kernel (as in the JAX package)")
    m = cfg.frame_in
    h = cfg.fft_size // 2
    fwd = _two_stage(m)
    if fwd is None:
        raise NotImplementedError(f"frame_in {m} outside the kernel's range")
    p, q = fwd
    plan = absorbed_plan(cfg)
    split = plan[:2] if plan is not None else _two_stage(h)
    if split is None or m % split[1] != 0:
        raise NotImplementedError(f"fft_size {cfg.fft_size} outside the "
                                  "kernel's range")
    p2, q2 = split
    j0 = cfg.overlap // 2
    k2_0 = j0 // p2
    halves = cfg.ratio == 1
    return dict(m=m, P=p, Q=q, h=h, P2=p2, Q2=q2, r=m // q2,
                depth_i1=p2 if halves else m // q2, kept=q2 - k2_0,
                k2_0=k2_0, j0=j0, block=cfg.block_size,
                absorbed=plan is not None, halves=halves)


def _complex(builder, *args) -> tuple[np.ndarray]:
    """``builder(*args)``'s (re, im) pair as one [..., 2] float32 array
    (the kernel reads it as float2)."""
    re, im = builder(*args)
    return (np.ascontiguousarray(np.stack([re, im], -1), dtype=np.float32),)


def kernel_consts(cfg: OverlapSaveConfig, device) -> dict[str, torch.Tensor]:
    """The kernel's static complex constants for ``cfg`` as [..., 2]
    float32 tensors on ``device`` (cached per device):
    w_p [P, P] and w_q [Q, Q] (forward DFTs), tw_m [P, Q] (forward
    twiddle), w2 [Q2, kept] (pruned inverse stage 2) and, for the folded
    path, w_p2 [P2, P2] (inverse stage 1) and tw_h [P2, Q2]."""
    pl = kernel_plan(cfg)

    def get(builder, *args):
        return _fft.device_consts(_complex, (builder, *args), device)[0]

    out = {
        "w_p": get(_fft._dft_matrix, pl["P"], False),
        "tw_m": get(_fft._twiddle, pl["P"], pl["Q"], False),
        "w_q": get(_fft._dft_matrix, pl["Q"], False),
        "w2": get(_stage2_matrix, pl["Q2"], pl["P2"], pl["k2_0"]),
    }
    if not pl["absorbed"]:
        out["w_p2"] = get(_fft._dft_matrix, pl["P2"], True)
        out["tw_h"] = get(_fft._twiddle, pl["P2"], pl["Q2"], True)
    return out


def flops_per_launch(cfg: OverlapSaveConfig) -> dict[str, int]:
    """Real FLOPs per frame of each of the kernel's four complex products,
    keyed F1, F2, I1, I2 (8 per complex multiply-add; F1 counted as real
    input, 4 per MAC; the ratio-1 sum of halves in I1's loader is not
    counted)."""
    pl = kernel_plan(cfg)
    return {
        "F1": 4 * pl["m"] * pl["P"],
        "F2": 8 * pl["m"] * pl["Q"],
        "I1": 8 * pl["h"] * pl["depth_i1"],
        "I2": 8 * pl["P2"] * pl["Q2"] * pl["kept"],
    }


def flops_per_frame(cfg: OverlapSaveConfig) -> int:
    """Real FLOPs the kernel's four complex products need per frame."""
    return sum(flops_per_launch(cfg).values())


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_frames")
    fn = lib.totton_fused_frames
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 10 + [ctypes.c_longlong] + [vp] * 2
                       + [i32] * 13 + [vp])
        fn.restype = i32
        lib.totton_cuda_error_string.argtypes = [i32]
        lib.totton_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, device: torch.device, shape=None):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")


def _launch_cuda(frames: torch.Tensor, bundle: FoldedBundle,
                 cfg: OverlapSaveConfig) -> torch.Tensor:
    global LAUNCHES
    pl = kernel_plan(cfg)
    dev = frames.device
    n = frames.shape[0]
    _check(frames, "frames", dev, (n, pl["m"]))
    if bundle.absorbed != pl["absorbed"]:
        raise ValueError("bundle was folded for another geometry")
    w = bundle.weights
    if pl["absorbed"]:
        _check(w, "bundle.weights", dev, (pl["Q2"], pl["r"], pl["P2"], 2))
    elif pl["halves"]:
        _check(w, "bundle.weights", dev, (2, pl["h"], 2))
    else:
        _check(w, "bundle.weights", dev, (pl["h"], 2))
    out = torch.empty((n, pl["block"]), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    consts = kernel_consts(cfg, dev)
    scratch_b = torch.empty((n, pl["m"], 2), dtype=torch.float32, device=dev)
    scratch_x = torch.empty_like(scratch_b)
    scratch_c = torch.empty((n, pl["h"], 2), dtype=torch.float32, device=dev)
    if pl["absorbed"]:
        g_nat, w1, w1_stride, tw_h = 0, w.data_ptr(), pl["r"] * pl["P2"], 0
    else:
        g_nat, w1, w1_stride = w.data_ptr(), consts["w_p2"].data_ptr(), 0
        tw_h = consts["tw_h"].data_ptr()
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.totton_fused_frames(
        frames.data_ptr(), out.data_ptr(),
        scratch_b.data_ptr(), scratch_x.data_ptr(), scratch_c.data_ptr(),
        consts["w_p"].data_ptr(), consts["tw_m"].data_ptr(),
        consts["w_q"].data_ptr(), g_nat, w1, w1_stride, tw_h,
        consts["w2"].data_ptr(),
        n, pl["m"], pl["P"], pl["Q"], pl["P2"], pl["Q2"], pl["r"],
        pl["kept"], pl["k2_0"], pl["j0"], pl["block"],
        pl["P2"].bit_length() - 1, int(pl["halves"]), stream)
    if rc != 0:
        msg = lib.totton_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_frames launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return out


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
