"""Time-domain cascaded-biquad EQ (alternate application path) on torch.

The primary EQ path bakes the response into the convolution filter spectrum
(zero runtime cost). This cascade exists for chains with no convolution
stage (e.g. EQ-only passthrough): transposed-direct-form-II biquads run
over time with carried per-band state for streaming.

Counterpart of ``totton_tpu/eq/iir.py``, whose ``_cascade_scan`` (:42-73)
is an XLA program (``jax.lax.scan`` over time, a ``fori_loop`` over the
bands, vmapped over channels). Two implementations sit under
``cascade``:

- plain torch (``cascade_plain``): a loop over samples, vectorised over
  channels, with the same TDF2 update in the same order. It is the CPU
  path and the oracle of the kernel.
- the hand-written CUDA kernel ``csrc/biquad_cascade.cu`` (one thread per
  channel, coefficients and state in registers; at most
  ``MAX_BANDS`` bands a launch, a longer cascade runs as consecutive
  groups). What bounds it is the recursion's chain of dependent FMAs
  (see the .cu header), not bytes.

Rules: a CPU tensor runs the plain version; a CUDA tensor runs the kernel
or raises (a build error names nvcc's output). ``LAUNCHES`` counts
kernel launches. Both round as the reference's XLA program does (fused
multiply-adds where XLA contracts; the kernel writes them out as
intrinsics), so they agree to the last bit but for a rare double
rounding of the plain version's float64 emulation; the tests hold them
to rel 1e-5 of the peak.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from totton_tpu_torch import resolve_device
from totton_tpu_torch.eq.apo import EqProfile
from totton_tpu_torch.eq.biquad import biquad_coeffs
from totton_tpu_torch.ops import _build

#: Number of times the CUDA kernel was launched. Reset it to 0 to count
#: the launches of one run.
LAUNCHES = 0

#: Bands one launch takes (the .cu's MAX_BANDS).
MAX_BANDS = 16


def profile_to_coeff_matrix(
    profile: EqProfile, sample_rate: float
) -> tuple[np.ndarray, float]:
    """(S, 5) float32 matrix of [b0, b1, b2, a1, a2] rows for the enabled,
    non-identity bands, plus the linear preamp gain."""
    rows = []
    for band in profile.bands:
        c = biquad_coeffs(band, sample_rate)
        if not c.is_identity:
            rows.append([c.b0, c.b1, c.b2, c.a1, c.a2])
    if not rows:
        rows = [[1.0, 0.0, 0.0, 0.0, 0.0]]
    preamp = 10.0 ** (profile.preamp_db / 20.0)
    return np.asarray(rows, dtype=np.float32), float(preamp)


def cascade_plain(x: torch.Tensor, coeffs: torch.Tensor,
                  state: torch.Tensor, preamp: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x [C, T], coeffs [S, 5], state [C, S, 2] ->
    (y [C, T], new state [C, S, 2]), float32, on x's device.

    The reference's update in the reference's order and with its
    roundings: XLA contracts ``b0 * v + s1``, ``b1 * v - a1 * y`` and
    ``b2 * v - a2 * y`` into fused multiply-adds (one rounding each; the
    product ``a * y`` and the ``+ s2`` round on their own). A fused
    multiply-add is computed here in float64, where the product of two
    float32 values is exact, then rounded to float32."""
    rows = coeffs.detach().cpu().tolist()
    s1 = [state[:, i, 0].clone() for i in range(len(rows))]
    s2 = [state[:, i, 1].clone() for i in range(len(rows))]
    pre = torch.tensor(preamp, dtype=torch.float32, device=x.device)
    out = []
    for t in range(x.shape[1]):
        v = x[:, t] * pre
        for i, (b0, b1, b2, a1, a2) in enumerate(rows):
            v64 = v.double()
            y = (v64 * b0 + s1[i]).float()
            s1[i] = (v64 * b1 - y * a1).float() + s2[i]
            s2[i] = (v64 * b2 - y * a2).float()
            v = y
        out.append(v)
    y = (torch.stack(out, dim=1) if out
         else torch.empty_like(x, dtype=torch.float32))
    new_state = torch.stack([torch.stack(s1, 1), torch.stack(s2, 1)], 2)
    return y, new_state


def _lib() -> ctypes.CDLL:
    lib = _build.load("biquad_cascade")
    fn = lib.totton_biquad_cascade
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_float, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
        lib.totton_cuda_error_string.argtypes = [ctypes.c_int]
        lib.totton_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch_cuda(x: torch.Tensor, coeffs: torch.Tensor, state: torch.Tensor,
                 preamp: float) -> tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    dev = x.device
    c, n = x.shape
    s = coeffs.shape[0]
    _build.check_tensor(x, "x", dev, (c, n))
    _build.check_tensor(coeffs, "coeffs", dev, (s, 5))
    _build.check_tensor(state, "state", dev, (c, s, 2))
    if n == 0:
        return torch.empty_like(x), state.clone()
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    new_state = state.clone()
    src, y = x, None
    with torch.cuda.device(dev):
        for lo in range(0, s, MAX_BANDS):
            hi = min(lo + MAX_BANDS, s)
            # A group's state is a contiguous copy, written back after.
            group = new_state[:, lo:hi].contiguous()
            y = torch.empty_like(x)
            rc = lib.totton_biquad_cascade(
                src.data_ptr(), y.data_ptr(), coeffs[lo:hi].data_ptr(),
                group.data_ptr(), preamp if lo == 0 else 1.0, c, n, hi - lo,
                stream)
            if rc != 0:
                msg = lib.totton_cuda_error_string(rc).decode()
                raise RuntimeError(f"biquad_cascade launch failed: {msg} "
                                   f"({rc})")
            LAUNCHES += 1
            new_state[:, lo:hi] = group
            src = y
    return y, new_state


def cascade(x: torch.Tensor, coeffs: torch.Tensor, state: torch.Tensor,
            preamp: float) -> tuple[torch.Tensor, torch.Tensor]:
    """x [C, T], coeffs [S, 5], state [C, S, 2] (float32, one device) ->
    (y [C, T], new state). CUDA tensors run the hand-written kernel (or
    raise); CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return cascade_plain(x, coeffs, state, preamp)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch_cuda(x, coeffs, state, preamp)


class BiquadCascade:
    """Stateful streaming cascade for a fixed profile and channel count,
    its coefficients and state on ``device``."""

    def __init__(self, profile: EqProfile, sample_rate: float, channels: int,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        coeffs, preamp = profile_to_coeff_matrix(profile, sample_rate)
        self._coeffs = torch.as_tensor(coeffs, device=self.device)
        self._preamp = float(np.float32(preamp))
        self._state = torch.zeros((channels, coeffs.shape[0], 2),
                                  dtype=torch.float32, device=self.device)

    def process(self, x: np.ndarray) -> np.ndarray:
        """x: [channels, n] float32 -> filtered [channels, n]."""
        xt = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                             device=self.device)
        y, self._state = cascade(xt, self._coeffs, self._state, self._preamp)
        return y.cpu().numpy()

    def reset(self) -> None:
        self._state = torch.zeros_like(self._state)


def make_cascade_step(profile: EqProfile, sample_rate: float, channels: int,
                      device: str | torch.device = "cuda"):
    """Functional streaming step: returns (step_fn, initial_state) where
    step_fn(x[C,T], state) -> (y[C,T], new_state), tensors on
    ``device``."""
    dev = resolve_device(device)
    coeffs, preamp = profile_to_coeff_matrix(profile, sample_rate)
    coeffs_t = torch.as_tensor(coeffs, device=dev)
    preamp_f = float(np.float32(preamp))
    state0 = torch.zeros((channels, coeffs.shape[0], 2),
                         dtype=torch.float32, device=dev)

    def step(x, state):
        return cascade(x, coeffs_t, state, preamp_f)

    return step, state0


def biquad_cascade(
    x: np.ndarray, profile: EqProfile, sample_rate: float,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """One-shot convenience: filter [channels, n] through the profile."""
    x = np.atleast_2d(np.asarray(x, dtype=np.float32))
    cascade_ = BiquadCascade(profile, sample_rate, x.shape[0], device=device)
    return cascade_.process(x)
