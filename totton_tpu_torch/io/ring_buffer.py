"""Single-producer single-consumer audio ring buffer.

Semantics parity with the reference's lock-free AudioRingBuffer
(include/io/audio_ring_buffer.h): fixed capacity, write/read return False /
empty on overflow/underflow (no partial transfers), wraparound memcpy,
clear() requires external synchronization.

This is the pure-Python/numpy implementation used by the streaming session;
a C++ SPSC implementation with acquire/release atomics lives in
totton_tpu/native (used when the compiled extension is available) for
multi-thread feeder/drainer pipelines.
"""

from __future__ import annotations

import threading

import numpy as np


def make_ring_buffer(capacity: int):
    """Best available SPSC ring: the lock-free native C++ implementation
    when compiled, else this module's locked Python one."""
    from totton_tpu_torch import native

    if native.available():
        return native.NativeRingBuffer(capacity)
    return AudioRingBuffer(capacity)


class AudioRingBuffer:
    """Float32 SPSC ring buffer of fixed capacity (in samples)."""

    def __init__(self, capacity: int = 0) -> None:
        self._buf: np.ndarray | None = None
        self._capacity = 0
        self._head = 0  # read position
        self._tail = 0  # write position
        self._size = 0
        self._lock = threading.Lock()
        if capacity:
            self.init(capacity)

    def init(self, capacity: int) -> bool:
        if capacity <= 0:
            return False
        self._buf = np.zeros(capacity, dtype=np.float32)
        self._capacity = capacity
        self._head = self._tail = self._size = 0
        return True

    @property
    def capacity(self) -> int:
        return self._capacity

    def available_to_read(self) -> int:
        return self._size

    def available_to_write(self) -> int:
        return self._capacity - self._size

    def write(self, data: np.ndarray) -> bool:
        """All-or-nothing append; False on overflow or uninitialized buffer."""
        if self._buf is None:
            return False
        data = np.asarray(data, dtype=np.float32).ravel()
        n = len(data)
        with self._lock:
            if n > self._capacity - self._size:
                return False
            first = min(n, self._capacity - self._tail)
            self._buf[self._tail : self._tail + first] = data[:first]
            rest = n - first
            if rest:
                self._buf[:rest] = data[first:]
            self._tail = (self._tail + n) % self._capacity
            self._size += n
        return True

    def read(self, n: int) -> np.ndarray | None:
        """All-or-nothing pop of n samples; None on underflow."""
        if self._buf is None:
            return None
        with self._lock:
            if n > self._size or n < 0:
                return None
            out = np.empty(n, dtype=np.float32)
            first = min(n, self._capacity - self._head)
            out[:first] = self._buf[self._head : self._head + first]
            rest = n - first
            if rest:
                out[first:] = self._buf[:rest]
            self._head = (self._head + n) % self._capacity
            self._size -= n
        return out

    def clear(self) -> None:
        with self._lock:
            self._head = self._tail = self._size = 0
