"""Build and load the port's CUDA kernels (nvcc by hand, ctypes binding).

The sources under ``totton_tpu_torch/csrc`` are compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -split-compile=0

into ``<build root>/<hash>/``, keyed by a hash of the sources and flags,
and loaded with ctypes; ``check_tensor`` validates a wrapper's arguments
before their pointers go to a kernel. The build root is
``$TOTTON_TORCH_BUILD_DIR`` when
set, else ``build/totton_tpu_torch/`` at the root of the checkout the
package sits in, else (an installed package) a per-user cache directory.
A plain C interface keeps the build to seconds (no PyTorch headers);
``-split-compile=0`` runs the device optimizer on every core: the frame
kernel's 64 template instances build in about half the time, and run as
fast.
Nothing here runs at import time: this module imports on machines without
nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-split-compile=0",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: each library's load in this process (``load``: the sources' hash, a
#: build where none is cached, ``ctypes.CDLL``): name -> (start, end),
#: each a (``perf_counter_ns``, ``thread_time_ns``) reading
loads: dict[str, tuple[tuple[int, int], tuple[int, int]]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH (or under /usr/local/cuda)")
    return path


def build_root() -> Path:
    """Where compiled kernels go (see the module docstring)."""
    env = os.environ.get("TOTTON_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    if (_PKG.parent / "pyproject.toml").exists():
        return _PKG.parent / "build" / "totton_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "totton_tpu_torch"


def _sources(name: str) -> list[Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    return [src, *sorted(CSRC.glob("*.cuh"))]


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if its hashed build is missing) and return
    the shared library's path."""
    sources = _sources(name)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        digest.update(s.read_bytes())
    out_dir = build_root() / digest.hexdigest()[:16]
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{name}.{os.getpid()}.so"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources[0])],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {sources[0].name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            since = (time.perf_counter_ns(), time.thread_time_ns())
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
            loads[name] = (since,
                           (time.perf_counter_ns(), time.thread_time_ns()))
        return lib


def check_tensor(t: torch.Tensor, name: str, device: torch.device,
                 shape=None) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor on ``device``
    (of ``shape`` when given): what the kernels take."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
