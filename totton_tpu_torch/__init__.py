"""totton-tpu on PyTorch and CUDA: the port of the JAX package to one NVIDIA H100.

The JAX package (``totton_tpu``) stays the reference; this package computes
the same functions with torch tensors and, on a CUDA device, runs the frame
computation through hand-written kernels (``totton_tpu_torch/csrc``). It
imports neither jax nor anything of the JAX package: the framework-free
host modules it needs (``filters/{sidecar,hrtf}``, ``io/{pcm,devices,
formats,wav,ring_buffer,sockets,serve_client}``, ``native``,
``eq/{apo,biquad}``, ``control``, ``utils/{intmath,profiling}``,
``web/{constants,services/config}``, ``testing/{signals,validate_output}``)
are copies at the same relative paths, held to the reference by
``tests/test_torch_copies.py``.

The signal path is float32 throughout and gated at > 125 dB against a
float64 oracle, so TF32 is switched off for every matmul on import.
"""

from __future__ import annotations

import time

#: the package's first line, as ``utils.profiling.Spans.clock()`` reads it:
#: the start of the import that ``StreamServer`` marks as
#: ``serve.setup.import``
_IMPORT_START = (time.perf_counter_ns(), time.thread_time_ns())

import torch  # noqa: E402

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """The torch device for ``name``. "cuda" resolves only when CUDA is
    present and raises otherwise: the port never falls back to the CPU on
    its own. Callers that want the CPU pass "cpu"."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available "
            "(pass device='cpu' explicitly to run the plain torch path)")
    return dev
