"""ctypes bindings for the native host runtime (totton_native.cpp).

A copy of ``totton_tpu/native/__init__.py``. Compiled on demand with g++
into the port's build root (``ops._build.build_root()/native``), never
next to the source; every entry point has a pure-Python fallback, so the
framework works without a toolchain. Disable with TOTTON_NATIVE=0.

Exposes:
  available() -> bool
  pcm_to_float / float_to_pcm        (numpy in/out, reference semantics)
  interleave / deinterleave
  NativeRingBuffer                   (lock-free SPSC, no GIL-held memcpy)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

from totton_tpu_torch.ops._build import build_root

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "totton_native.cpp")
_LIB_PATH = os.path.join(build_root(), "native", "_totton_native.so")

_lib = None
_load_lock = threading.Lock()
_load_attempted = False


def _build() -> bool:
    # Built under a per-process name and renamed into place, so concurrent
    # processes sharing the build root never load a half-written library.
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        "-o", tmp, _SRC,
    ]
    # -march=native helps the conversion loops vectorize; fall back to
    # generic flags if unsupported.
    try:
        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        res = subprocess.run(cmd[:2] + ["-march=native"] + cmd[2:],
                             capture_output=True, timeout=120)
        if res.returncode != 0:
            res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0:
            print(f"totton_native build failed:\n{res.stderr.decode()[:500]}",
                  file=sys.stderr)
            return False
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False


def _bind(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    p = ctypes.c_void_p
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.pcm_s16_to_float.argtypes = [p, f32p, i64]
    lib.pcm_s24_to_float.argtypes = [p, f32p, i64]
    lib.pcm_s32_to_float.argtypes = [p, f32p, i64]
    lib.float_to_pcm_s16.argtypes = [f32p, p, i64]
    lib.float_to_pcm_s24.argtypes = [f32p, p, i64]
    lib.float_to_pcm_s32.argtypes = [f32p, p, i64]
    lib.interleave_f32.argtypes = [f32p, f32p, i64, i64]
    lib.deinterleave_f32.argtypes = [f32p, f32p, i64, i64]
    lib.ring_create.argtypes = [i64]
    lib.ring_create.restype = p
    lib.ring_destroy.argtypes = [p]
    lib.ring_capacity.argtypes = [p]
    lib.ring_capacity.restype = i64
    lib.ring_available_read.argtypes = [p]
    lib.ring_available_read.restype = i64
    lib.ring_available_write.argtypes = [p]
    lib.ring_available_write.restype = i64
    lib.ring_write.argtypes = [p, f32p, i64]
    lib.ring_write.restype = ctypes.c_int
    lib.ring_read.argtypes = [p, f32p, i64]
    lib.ring_read.restype = ctypes.c_int
    lib.ring_clear.argtypes = [p]
    lib.totton_native_abi_version.restype = ctypes.c_int


def _load():
    global _lib, _load_attempted
    with _load_lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get("TOTTON_NATIVE", "1") == "0":
            return None
        try:
            if not os.path.exists(_LIB_PATH) or (
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)
            ):
                if not _build():
                    return None
            lib = ctypes.CDLL(_LIB_PATH)
            _bind(lib)
            if lib.totton_native_abi_version() != 1:
                return None
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def pcm_to_float(data: bytes | np.ndarray, fmt) -> np.ndarray | None:
    """Native conversion; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray
    ) else np.ascontiguousarray(data).view(np.uint8).ravel()
    n = len(buf) // fmt.bytes
    out = np.empty(n, dtype=np.float32)
    src = buf.ctypes.data_as(ctypes.c_void_p)
    if fmt.value == "S16_LE":
        lib.pcm_s16_to_float(src, _f32p(out), n)
    elif fmt.value == "S24_3LE":
        lib.pcm_s24_to_float(src, _f32p(out), n)
    else:
        lib.pcm_s32_to_float(src, _f32p(out), n)
    return out


def float_to_pcm(x: np.ndarray, fmt) -> bytes | None:
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32).ravel()
    out = np.empty(len(x) * fmt.bytes, dtype=np.uint8)
    dst = out.ctypes.data_as(ctypes.c_void_p)
    if fmt.value == "S16_LE":
        lib.float_to_pcm_s16(_f32p(x), dst, len(x))
    elif fmt.value == "S24_3LE":
        lib.float_to_pcm_s24(_f32p(x), dst, len(x))
    else:
        lib.float_to_pcm_s32(_f32p(x), dst, len(x))
    return out.tobytes()


def interleave(x: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    channels, frames = x.shape
    out = np.empty(channels * frames, dtype=np.float32)
    lib.interleave_f32(_f32p(x), _f32p(out), channels, frames)
    return out


def deinterleave(x: np.ndarray, channels: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32).ravel()
    frames = len(x) // channels
    out = np.empty((channels, frames), dtype=np.float32)
    lib.deinterleave_f32(_f32p(x), _f32p(out), channels, frames)
    return out


class NativeRingBuffer:
    """Lock-free SPSC float ring backed by the C++ implementation.

    API-compatible with totton_tpu.io.ring_buffer.AudioRingBuffer. Unlike
    the Python version there is no lock: safe for exactly one producer
    thread and one consumer thread.
    """

    def __init__(self, capacity: int = 0) -> None:
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._handle = None
        if capacity:
            self.init(capacity)

    def init(self, capacity: int) -> bool:
        if capacity <= 0:
            return False
        if self._handle:
            self._lib.ring_destroy(self._handle)
        self._handle = self._lib.ring_create(capacity)
        return self._handle is not None

    def __del__(self):
        if getattr(self, "_handle", None) and getattr(self, "_lib", None):
            self._lib.ring_destroy(self._handle)
            self._handle = None

    @property
    def capacity(self) -> int:
        return self._lib.ring_capacity(self._handle) if self._handle else 0

    def available_to_read(self) -> int:
        return self._lib.ring_available_read(self._handle) if self._handle else 0

    def available_to_write(self) -> int:
        return self._lib.ring_available_write(self._handle) if self._handle else 0

    def write(self, data: np.ndarray) -> bool:
        if not self._handle:
            return False
        data = np.ascontiguousarray(data, dtype=np.float32).ravel()
        return bool(self._lib.ring_write(self._handle, _f32p(data), len(data)))

    def read(self, n: int) -> np.ndarray | None:
        if not self._handle or n < 0:
            return None
        out = np.empty(n, dtype=np.float32)
        if not self._lib.ring_read(self._handle, _f32p(out), n):
            return None
        return out

    def clear(self) -> None:
        if self._handle:
            self._lib.ring_clear(self._handle)
