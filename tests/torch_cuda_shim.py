"""Run a CUDA kernel source of the port on the CPU, for the Tier-1 tests.

``build_library`` compiles a ``csrc/*.cu`` file with g++ against the small
``cuda_runtime.h`` below, in which each lane of a block is a
``std::thread`` (``threadIdx`` and ``blockIdx`` thread-local,
``__syncwarp`` and ``__syncthreads`` a ``std::barrier``), a ``__shared__``
array is one static buffer and the dynamic shared memory
(``extern __shared__``) one buffer of the launch's size, fresh and filled
with NaN for every block (the launch runs its blocks one after another,
so a read of a slot no lane wrote shows), ``__ldg`` a plain load and
``__fmaf_rn`` ``std::fmaf``. The header emulates no warp shuffle: the
kernels use none. ``name<<<grid, block, smem, stream>>>(`` becomes
``shim_launch(grid, block, smem, stream, name, `` (a regex on the
source). The library is built with ``-O1 -ffp-contract=off`` and its C
entries are called through ctypes with CPU tensors.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

SHIM = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __shared__ static

struct shim_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local shim_dim3 threadIdx, blockIdx;
inline thread_local std::barrier<>* shim_block_barrier = nullptr;
inline thread_local void* shim_dynamic_smem = nullptr;

struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
template <class T> inline T __ldg(const T* p) { return *p; }

using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid argument";
}
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}

inline void __syncwarp(unsigned = 0xffffffffu) {
  shim_block_barrier->arrive_and_wait();
}
inline void __syncthreads() { shim_block_barrier->arrive_and_wait(); }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }

// kernel<<<grid, block, smem, stream>>>(args...), one block at a time.
template <class K, class... A>
void shim_launch(unsigned grid, unsigned block, std::size_t smem,
                 cudaStream_t, K kernel, A... args) {
  for (unsigned b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    std::vector<float> dyn(smem / sizeof(float) + 1, NAN);
    std::vector<std::thread> lanes;
    for (unsigned t = 0; t < block; ++t) {
      lanes.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        shim_block_barrier = &bar;
        shim_dynamic_smem = dyn.data();
        kernel(args...);
      });
    }
    for (auto& lane : lanes) lane.join();
  }
}
"""


def cpu_source(text: str) -> str:
    """A kernel source rewritten for the shim: every launch through
    ``shim_launch`` and the dynamic shared memory a pointer to the block's
    buffer."""
    src = re.sub(r"(\w+)<<<(.*?)>>>\(", r"shim_launch(\2, \1, ", text,
                 flags=re.S)
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = static_cast<\1*>(shim_dynamic_smem);", src)
    assert "shim_launch(" in src, "the source's launch was not found"
    return src


def build_library(source: Path, out_dir: Path) -> ctypes.CDLL:
    """``source`` compiled for the CPU into ``out_dir`` and loaded; skips
    without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source on the CPU")
    (out_dir / "cuda_runtime.h").write_text(SHIM)
    cpp = out_dir / (source.stem + ".cpp")
    cpp.write_text(cpu_source(source.read_text()))
    lib = out_dir / f"lib{source.stem}_cpu.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-I", str(out_dir), "-o", str(lib), str(cpp)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))
