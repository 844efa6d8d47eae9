// Time-domain cascaded-biquad EQ for an NVIDIA H100 (sm_90a).
//
// Replaces the JAX package's device program for the same function:
// totton_tpu/eq/iir.py `_cascade_scan` (:42-73), a jax.lax.scan over time
// with a fori_loop over the bands, vmapped over channels (an XLA program,
// not a Pallas kernel). Wrapper: totton_tpu_torch/eq/iir.py.
//
// Function: for every channel c and sample t, v = x[c, t] * preamp, then
// for each band i in order the transposed-direct-form-II update
//
//     y      = b0 * v + s1
//     s1_new = b1 * v - a1 * y + s2
//     s2_new = b2 * v - a2 * y
//     v      = y
//
// and out[c, t] = v; the state [C, S, 2] (s1, s2 per band) is read at the
// start and written back at the end, so calls chain across a stream.
//
// Rounding: the reference's. XLA contracts b0 * v + s1, b1 * v - a1 * y
// and b2 * v - a2 * y into fused multiply-adds, and rounds the product
// a * y and the sum with s2 on their own; the update is written out in
// those intrinsics (__fmaf_rn, __fmul_rn, __fadd_rn), which nvcc neither
// contracts nor reorders, so the kernel computes the plain version's
// float32 values.
//
// What bounds it: latency, not bytes or FLOPs. Sample t + 1 needs each
// band's state from sample t, so the recursion is a chain of dependent
// operations: each band's own y -> a1 * y -> fma -> + s2 -> y is four a
// sample, and the bands pipeline behind each other, so no schedule of
// this arithmetic finishes in fewer than about 4T + S dependent
// operations per channel. The design here is the first, simple one: one
// thread per channel walks the samples in order and, for each, all S
// bands (coefficients and state in registers, S a template parameter up
// to MAX_BANDS; the wrapper runs a longer cascade as consecutive groups
// of bands, which is the same arithmetic). Its own chain is y through
// the bands, about T x S fused multiply-adds. A warp-pipelined form
// (band i in lane i, y handed on with __shfl_up_sync, T + S steps) is
// the follow-up.
//
// Interface (plain C, loaded with ctypes): every pointer is device memory
// on the current card; the launch goes to `stream_ptr`; returns the first
// CUDA error (cudaGetLastError after the launch), 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_BANDS = 16;
constexpr int THREADS = 32;

template <int S>
__global__ void cascade_kernel(const float* __restrict__ x,
                               float* __restrict__ y,
                               const float* __restrict__ coeffs,
                               float* __restrict__ state, float preamp,
                               int channels, long long n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float b0[S], b1[S], b2[S], a1[S], a2[S], s1[S], s2[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    b0[i] = coeffs[5 * i + 0];
    b1[i] = coeffs[5 * i + 1];
    b2[i] = coeffs[5 * i + 2];
    a1[i] = coeffs[5 * i + 3];
    a2[i] = coeffs[5 * i + 4];
    s1[i] = state[(static_cast<long long>(c) * S + i) * 2 + 0];
    s2[i] = state[(static_cast<long long>(c) * S + i) * 2 + 1];
  }
  const float* xc = x + static_cast<long long>(c) * n;
  float* yc = y + static_cast<long long>(c) * n;
#pragma unroll 4
  for (long long t = 0; t < n; ++t) {
    float v = __fmul_rn(xc[t], preamp);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float out = __fmaf_rn(b0[i], v, s1[i]);
      s1[i] = __fadd_rn(__fmaf_rn(b1[i], v, -__fmul_rn(a1[i], out)), s2[i]);
      s2[i] = __fmaf_rn(b2[i], v, -__fmul_rn(a2[i], out));
      v = out;
    }
    yc[t] = v;
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    state[(static_cast<long long>(c) * S + i) * 2 + 0] = s1[i];
    state[(static_cast<long long>(c) * S + i) * 2 + 1] = s2[i];
  }
}

template <int S = 1>
cudaError_t dispatch(int bands, const float* x, float* y, const float* coeffs,
                     float* state, float preamp, int channels, long long n,
                     cudaStream_t stream) {
  if constexpr (S <= MAX_BANDS) {
    if (bands == S) {
      const int blocks = (channels + THREADS - 1) / THREADS;
      cascade_kernel<S><<<blocks, THREADS, 0, stream>>>(
          x, y, coeffs, state, preamp, channels, n);
      return cudaGetLastError();
    }
    return dispatch<S + 1>(bands, x, y, coeffs, state, preamp, channels, n,
                           stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: [channels, n] float32; coeffs: [bands, 5] float32 rows of
// (b0, b1, b2, a1, a2); state: [channels, bands, 2] float32, updated in
// place. 1 <= bands <= MAX_BANDS (16, eq/iir.py's MAX_BANDS).
extern "C" int totton_biquad_cascade(const float* x, float* y,
                                     const float* coeffs, float* state,
                                     float preamp, int channels, long long n,
                                     int bands, void* stream_ptr) {
  if (bands < 1 || bands > MAX_BANDS || channels < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch(bands, x, y, coeffs, state, preamp,
                                   channels, n,
                                   static_cast<cudaStream_t>(stream_ptr)));
}

extern "C" const char* totton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
