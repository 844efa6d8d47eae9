"""State conversion from the JAX package to the port.

``from_jax`` turns the JAX engine's state — its filter spectrum (re, im)
pair and carried input tail, as numpy arrays — into the port's folded
bundle and tail tensor, and ``cascade_from_jax`` the time-domain EQ
cascade's carried state and coefficients into the port's tensors, so both
packages compute the same thing from the same state. The JAX arrays arrive as numpy; this module never imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from totton_tpu_torch.ops.overlap_save import (
    FoldedBundle,
    OverlapSaveConfig,
    fold_bundle,
)


def from_jax(spectrum_pair, cfg: OverlapSaveConfig, tail=None,
             device: str | torch.device = "cpu"
             ) -> tuple[FoldedBundle, torch.Tensor | None]:
    """(folded bundle, tail) on ``device`` from a JAX-side spectrum pair
    ([n_bins] float32 re and im) and an optional [C, halo_in] tail."""
    re, im = (np.array(a, dtype=np.float32) for a in spectrum_pair)
    if re.shape != (cfg.n_bins,) or im.shape != (cfg.n_bins,):
        raise ValueError(f"spectrum pair must be [{cfg.n_bins}] each, got "
                         f"{re.shape} and {im.shape}")
    spectrum = (torch.as_tensor(re, device=device),
                torch.as_tensor(im, device=device))
    t = None
    if tail is not None:
        tail = np.array(tail, dtype=np.float32)
        if tail.ndim != 2 or tail.shape[1] != cfg.halo_in:
            raise ValueError(f"tail must be [C, {cfg.halo_in}], got "
                             f"{tail.shape}")
        t = torch.as_tensor(tail, device=device)
    return fold_bundle(spectrum, cfg), t


def cascade_from_jax(state, coeffs, preamp,
                     device: str | torch.device = "cpu"
                     ) -> tuple[torch.Tensor, torch.Tensor, float]:
    """(state [C, S, 2], coeffs [S, 5], preamp) for ``eq.iir.cascade`` on
    ``device`` from the JAX cascade's carried state and its
    (coefficients, preamp), as numpy, so that a stream the JAX package
    started continues in the port."""
    coeffs = np.array(coeffs, dtype=np.float32)
    state = np.array(state, dtype=np.float32)
    if coeffs.ndim != 2 or coeffs.shape[1] != 5:
        raise ValueError(f"coeffs must be [S, 5], got {coeffs.shape}")
    if state.ndim != 3 or state.shape[1:] != (coeffs.shape[0], 2):
        raise ValueError(f"state must be [C, {coeffs.shape[0]}, 2], got "
                         f"{state.shape}")
    return (torch.as_tensor(state, device=device),
            torch.as_tensor(coeffs, device=device),
            float(np.float32(preamp)))
