// Overlap-save frame kernel for Hopper (sm_90a): frames [N, m] f32 ->
// output blocks [N, block] f32, the even/odd interleave written in place.
//
// Replaces the Pallas kernel totton_tpu/experimental/pallas_kernels.py
// (_fused_kernel, :284-317; pallas_call at :355), which kept one whole frame
// in TPU VMEM and ran its DFT stages as dense products on the matrix unit.
// On this card the dense products cost 1334 FLOP per output sample at
// 16x/80k on the CUDA cores; radix FFTs cost about 91. So every stage here
// is a batch of short Stockham FFTs (radix 8, then one radix-2 or radix-4
// pass) run in shared memory, and the frame is split over launches because
// its half-size inverse (h = 65536 complex f32 = 512 KB at 16x/80k) does
// not fit a block's 227 KB:
//
//   FWD forward DFT of the real frame, X[n, k] in natural order:
//       m <= 16384: one launch ("fused" F1+F2), one M = m/2 point FFT per
//         frame of z[i] = x[2i] + i x[2i+1], untangled as it is stored:
//         X[k] = A[k] Z[k] + B[k] conj(Z[M - k]), A = (1 - i W_m^k)/2,
//         B = (1 + i W_m^k)/2, and X[M + k] = conj(X[M - k]);
//       else four-step in two launches, m = P*Q, x[p*Q + q]:
//         F1  B[n, k1, q] = W_m^{k1 q} * FFT_P over p
//         F2  X[n, k2*P + k1] = FFT_Q over q of B[n, k1, :]
//   I1  per (n, q2), h = P2*Q2, k = s*Q2 + q2:
//         Z[k] = X[k mod m] * G[k]          (ratio >= 2; G = G1 + G2)
//         Z[k] = X[k] G1[k] + X[k + h] G2[k] (ratio 1, h = m/2)
//       formed by the loader as it reads X (the filter never leaves G:
//       h complex bins, L2-resident across frames), then an inverse
//       P2-point FFT over s and the twiddle W_h^{+k1' q2}:
//         C[n, q2, k1']
//   I2  per (n, k1'): inverse Q2-point FFT over q2 of C[n, :, k1'];
//       z[k2'*P2 + k1'] is stored only where j = k2'*P2 + k1' >= j0 (the
//       overlap region is never stored) as out[n, 2(j - j0) + {0, 1}] =
//       (Re, Im) z[j]: the even/odd interleave, no trim or interleave pass.
//
// Every launch is one template, fft_stage: a block holds TB transforms of
// length N in shared memory, element i of transform t at sm[i*S + t] with
// S = TB + 1 (the pad keeps the column reads and writes free of bank
// conflicts), each thread holds 8 values per pass, and a loader and a
// store functor map (transform, element) to device memory with
// neighbouring threads on neighbouring addresses (kFastT says which index
// is contiguous). Twiddles come from
// tables built in float64 on the host and stored as f32 (forward W_N^e;
// an inverse stage multiplies by the conjugate).
//
// What bounds it: the bytes. At 16x/80k (P2 = Q2 = 256) a frame moves
// 32 KB in, X (64 KB) and C (512 KB) out and back, 204 KB out: about
// 1.4 MB against 4.7 MFLOP of FFT arithmetic, so the scratch round trips,
// not the FMAs, set the time; I1 also reads G and the [Q2, P2] twiddle
// table (512 KB each) from L2 for every frame. fp32 throughout, no tensor
// cores and no TF32 (the signal path is gated at > 125 dB); FFT rounding
// error grows with log N.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing, returns the first CUDA error (cudaGetLastError after each
// launch).

#include <cuda_runtime.h>

namespace {

typedef long long i64;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// ---- short DFTs in registers (natural order in and out) -----------------

// a * W_4: -i forward, +i inverse.
template <bool INV>
__device__ __forceinline__ float2 mul_w4(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// a * W_8: (1 - i)/sqrt2 forward, (1 + i)/sqrt2 inverse.
template <bool INV>
__device__ __forceinline__ float2 mul_w8(float2 a) {
  const float r = 0.70710678118654752f;
  return INV ? make_float2(r * (a.x - a.y), r * (a.x + a.y))
             : make_float2(r * (a.x + a.y), r * (a.y - a.x));
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 s0 = cadd(a0, a2), d0 = csub(a0, a2);
  const float2 s1 = cadd(a1, a3), d1 = mul_w4<INV>(csub(a1, a3));
  a0 = cadd(s0, s1);
  a2 = csub(s0, s1);
  a1 = cadd(d0, d1);
  a3 = csub(d0, d1);
}

template <int R, bool INV>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) {
    const float2 t = v[0];
    v[0] = cadd(t, v[1]);
    v[1] = csub(t, v[1]);
  } else if constexpr (R == 4) {
    dft4<INV>(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(R == 8, "radix 2, 4 or 8");
    float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
    dft4<INV>(e0, e1, e2, e3);
    dft4<INV>(o0, o1, o2, o3);
    o1 = mul_w8<INV>(o1);
    o2 = mul_w4<INV>(o2);
    o3 = mul_w4<INV>(mul_w8<INV>(o3));
    v[0] = cadd(e0, o0);
    v[4] = csub(e0, o0);
    v[1] = cadd(e1, o1);
    v[5] = csub(e1, o1);
    v[2] = cadd(e2, o2);
    v[6] = csub(e2, o2);
    v[3] = cadd(e3, o3);
    v[7] = csub(e3, o3);
  }
}

// ---- batched Stockham FFT in shared memory ------------------------------

// Block shape for transforms of length N: TB transforms per block, 8
// values per thread (TB * N / 8 threads: 512, or 1024 at N = 8192).
template <int N>
struct Tile {
  static constexpr int TB = N >= 4096 ? 1 : 4096 / N;
  static constexpr int S = TB == 1 ? 1 : TB + 1;
  static constexpr int NT = TB * N / 8;
  static constexpr int SMEM = N * S * (int)sizeof(float2);
};

// One Stockham pass of radix R over sub-transforms of size NS (in place:
// every thread reads its 8 values, the block syncs, then writes):
//   v[r] = d[j + r*N/R] * W_{NS*R}^{(j mod NS) r};  v = DFT_R(v);
//   d[(j / NS)*NS*R + (j mod NS) + r*NS] = v[r].
// After the passes (NS = 1, 8, 64, ...) the transform is in natural order.
template <int N, bool INV, int R, int NS>
__device__ __forceinline__ void radix_pass(float2* sm,
                                           const float2* __restrict__ tw,
                                           int t, int jf) {
  constexpr int S = Tile<N>::S;
  constexpr int TPT = N / 8;  // threads per transform
  constexpr int NB = 8 / R;   // butterflies per thread
  float2 v[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = jf + b * TPT;
#pragma unroll
    for (int r = 0; r < R; ++r) v[b][r] = sm[(j + r * (N / R)) * S + t];
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = jf + b * TPT;
    const int k = j & (NS - 1);
    if constexpr (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2 w = __ldg(tw + k * r * (N / (NS * R)));
        v[b][r] = INV ? cmulc(v[b][r], w) : cmul(v[b][r], w);
      }
    }
    dft<R, INV>(v[b]);
    const int d = (j / NS) * NS * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) sm[(d + r * NS) * S + t] = v[b][r];
  }
  __syncthreads();
}

template <int N, bool INV, int NS = 1>
__device__ __forceinline__ void fft_passes(float2* sm,
                                           const float2* __restrict__ tw,
                                           int t, int jf) {
  if constexpr (NS < N) {
    constexpr int R = (N / NS >= 8) ? 8 : N / NS;
    radix_pass<N, INV, R, NS>(sm, tw, t, jf);
    fft_passes<N, INV, NS * R>(sm, tw, t, jf);
  }
}

// Transforms T0 .. T0 + TB - 1 of `total`: load (ld), FFT, store (st).
template <int N, bool INV, class LD, class ST>
__global__ void __launch_bounds__(Tile<N>::NT)
    fft_stage(LD ld, ST st, const float2* __restrict__ tw, i64 total) {
  using TL = Tile<N>;
  extern __shared__ float2 sm[];
  const int tid = threadIdx.x;
  const i64 t0 = (i64)blockIdx.x * TL::TB;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const int e = tid + l * TL::NT;
    const int t = LD::kFastT ? e % TL::TB : e / N;
    const int i = LD::kFastT ? e / TL::TB : e % N;
    sm[i * TL::S + t] =
        t0 + t < total ? ld(t0 + t, i) : make_float2(0.f, 0.f);
  }
  __syncthreads();
  fft_passes<N, INV>(sm, tw, tid % TL::TB, tid / TL::TB);
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const int e = tid + l * TL::NT;
    const int t = ST::kFastT ? e % TL::TB : e / N;
    const int k = ST::kFastT ? e / TL::TB : e % N;
    if (t0 + t >= total) continue;
    if constexpr (ST::kPairs) {
      st(t0 + t, k, sm[k * TL::S + t], sm[((N - k) & (N - 1)) * TL::S + t]);
    } else {
      st(t0 + t, k, sm[k * TL::S + t]);
    }
  }
}

// ---- loaders (transform, element) -> value; stores (transform, bin, v) ---

// Whole-frame forward: transform n, element i -> z[i] = x[n, 2i] +
// i x[n, 2i + 1].
struct FrameLoad {
  const float* x;
  int m;
  static constexpr bool kFastT = false;
  __device__ float2 operator()(i64 n, int i) const {
    return __ldg(reinterpret_cast<const float2*>(x + n * m) + i);
  }
};

// Whole-frame forward, a kPairs store: given Z[k] and Z[(M - k) mod M],
// k < M = m/2, writes X[n, k] and X[n, M + k] = conj(X[M - k]); wm holds
// W_m^j, j = 0 .. M.
struct SpecStore {
  float2* x;
  const float2* wm;
  int m;
  static constexpr bool kFastT = false;
  static constexpr bool kPairs = true;
  __device__ static float2 untangle(float2 z, float2 zr, float2 w) {
    // A z + B conj(zr), A = ((1 + w.y)/2, -w.x/2), B = ((1 - w.y)/2, w.x/2).
    const float2 a = make_float2(0.5f * (1.f + w.y), -0.5f * w.x);
    const float2 b = make_float2(0.5f * (1.f - w.y), 0.5f * w.x);
    return cadd(cmul(a, z), cmul(b, make_float2(zr.x, -zr.y)));
  }
  __device__ void operator()(i64 n, int k, float2 z, float2 zr) const {
    const int half = m >> 1;
    float2* xn = x + n * m;
    xn[k] = untangle(z, zr, __ldg(wm + k));
    const float2 hi = untangle(zr, z, __ldg(wm + half - k));
    xn[half + k] = make_float2(hi.x, -hi.y);
  }
};

// F1: transform n*Q + q, element p -> x[n, p*Q + q] (real).
struct FwdStage1Load {
  const float* x;
  int m, lq;
  static constexpr bool kFastT = true;
  __device__ float2 operator()(i64 tr, int p) const {
    const i64 n = tr >> lq;
    const int q = (int)(tr & ((1 << lq) - 1));
    return make_float2(__ldg(x + n * m + ((i64)p << lq) + q), 0.f);
  }
};

// F1: B[n, k1, q] = v * W_m^{k1 q} (tw_m laid out [P, Q]).
struct FwdStage1Store {
  float2* b;
  const float2* tw;
  int m, lq;
  static constexpr bool kFastT = true;
  static constexpr bool kPairs = false;
  __device__ void operator()(i64 tr, int k1, float2 v) const {
    const i64 n = tr >> lq;
    const int q = (int)(tr & ((1 << lq) - 1));
    const int at = (k1 << lq) + q;
    b[n * m + at] = cmul(v, __ldg(tw + at));
  }
};

// F2: transform n*P + k1, element q -> B[n, k1, q] (contiguous rows).
struct FwdStage2Load {
  const float2* b;
  int lq;
  static constexpr bool kFastT = false;
  __device__ float2 operator()(i64 tr, int q) const {
    return b[(tr << lq) + q];
  }
};

// F2: X[n, k2*P + k1].
struct FwdStage2Store {
  float2* x;
  int m, lp;
  static constexpr bool kFastT = true;
  static constexpr bool kPairs = false;
  __device__ void operator()(i64 tr, int k2, float2 v) const {
    const i64 n = tr >> lp;
    const int k1 = (int)(tr & ((1 << lp) - 1));
    x[n * m + ((i64)k2 << lp) + k1] = v;
  }
};

// I1: transform n*Q2 + q2, element s, k = s*Q2 + q2 -> Z[k], the spectrum
// tiled and filtered as it is read (g = G [h], or G1 then G2 [2h] with
// `halves`).
struct InvStage1Load {
  const float2* x;
  const float2* g;
  int m, h, lq2, halves;
  static constexpr bool kFastT = true;
  __device__ float2 operator()(i64 tr, int s) const {
    const i64 n = tr >> lq2;
    const int k = (s << lq2) + (int)(tr & ((1 << lq2) - 1));
    const float2* xn = x + n * m;
    if (halves) {
      return cadd(cmul(xn[k], __ldg(g + k)), cmul(xn[k + h], __ldg(g + k + h)));
    }
    return cmul(xn[k & (m - 1)], __ldg(g + k));
  }
};

// I1: C[n, q2, k1'] = v * W_h^{+k1' q2} (tw_h laid out [Q2, P2], read
// along k1' as C is written).
struct InvStage1Store {
  float2* c;
  const float2* tw;
  int lq2, lp2;
  static constexpr bool kFastT = false;
  static constexpr bool kPairs = false;
  __device__ void operator()(i64 tr, int k1, float2 v) const {
    const int q2 = (int)(tr & ((1 << lq2) - 1));
    c[(tr << lp2) + k1] = cmul(v, __ldg(tw + (q2 << lp2) + k1));
  }
};

// I2: transform n*P2 + k1', element q2 -> C[n, q2, k1'].
struct InvStage2Load {
  const float2* c;
  int lq2, lp2;
  static constexpr bool kFastT = true;
  __device__ float2 operator()(i64 tr, int q2) const {
    const i64 n = tr >> lp2;
    const int k1 = (int)(tr & ((1 << lp2) - 1));
    return c[(((n << lq2) + q2) << lp2) + k1];
  }
};

// I2: j = k2'*P2 + k1' - j0; out[n, 2j + {0, 1}] = z for j >= 0.
struct OutStore {
  float* out;
  int lp2, block, j0;
  static constexpr bool kFastT = true;
  static constexpr bool kPairs = false;
  __device__ void operator()(i64 tr, int k2, float2 v) const {
    const i64 n = tr >> lp2;
    const int j = (k2 << lp2) + (int)(tr & ((1 << lp2) - 1)) - j0;
    if (j >= 0) reinterpret_cast<float2*>(out + n * block)[j] = v;
  }
};

// ---- launches ------------------------------------------------------------

template <int N, bool INV, class LD, class ST>
cudaError_t run(LD ld, ST st, const float2* tw, i64 total,
                cudaStream_t stream) {
  using TL = Tile<N>;
  auto kernel = fft_stage<N, INV, LD, ST>;
  if (TL::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
    if (e != cudaSuccess) return e;
  }
  const i64 blocks = (total + TL::TB - 1) / TL::TB;
  kernel<<<(unsigned)blocks, TL::NT, TL::SMEM, stream>>>(ld, st, tw, total);
  return cudaGetLastError();
}

// run<n> for the runtime length n, N = 16 .. MAXN.
template <int MAXN, bool INV, int N = 16, class LD, class ST>
cudaError_t dispatch(int n, LD ld, ST st, const float2* tw, i64 total,
                     cudaStream_t stream) {
  if (n == N) return run<N, INV>(ld, st, tw, total, stream);
  if constexpr (N < MAXN) {
    return dispatch<MAXN, INV, 2 * N>(n, ld, st, tw, total, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

int log2i(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

// frames [n_frames, m] -> out [n_frames, block]. Scratch: x [n_frames, m]
// complex; b [n_frames, m] complex (two-launch forward only, else null);
// c [n_frames, h] complex. Tables: tw_fwd the forward W_N^e of the
// forward transform (fused: W_{m/2}^e then W_m^j, j = 0 .. m/2; else W_P
// then W_Q), tw_m
// [P, Q] (two-launch only), tw_p2 / tw_q2 the forward W_P2^e / W_Q2^e,
// tw_h [Q2, P2] = W_h^{+k1' q2}.
extern "C" int totton_fused_frames(
    const float* frames, float* out, float2* scratch_b, float2* scratch_x,
    float2* scratch_c, const float2* g, const float2* tw_fwd,
    const float2* tw_m, const float2* tw_p2, const float2* tw_q2,
    const float2* tw_h, long long n_frames, int m, int P,
    int Q, int P2, int Q2, int block, int j0, int fused, int halves,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int h = P2 * Q2;
  const int lq = log2i(Q), lp = log2i(P), lq2 = log2i(Q2), lp2 = log2i(P2);
  cudaError_t e;
  if (fused) {
    e = dispatch<8192, false>(m / 2, FrameLoad{frames, m},
                              SpecStore{scratch_x, tw_fwd + m / 2, m}, tw_fwd,
                              n_frames, stream);
  } else {
    e = dispatch<512, false>(P, FwdStage1Load{frames, m, lq},
                             FwdStage1Store{scratch_b, tw_m, m, lq}, tw_fwd,
                             n_frames * Q, stream);
    if (e == cudaSuccess) {
      e = dispatch<512, false>(Q, FwdStage2Load{scratch_b, lq},
                               FwdStage2Store{scratch_x, m, lp}, tw_fwd + P,
                               n_frames * P, stream);
    }
  }
  if (e == cudaSuccess) {
    e = dispatch<512, true>(P2, InvStage1Load{scratch_x, g, m, h, lq2, halves},
                            InvStage1Store{scratch_c, tw_h, lq2, lp2}, tw_p2,
                            n_frames * Q2, stream);
  }
  if (e == cudaSuccess) {
    e = dispatch<512, true>(Q2, InvStage2Load{scratch_c, lq2, lp2},
                            OutStore{out, lp2, block, j0}, tw_q2,
                            n_frames * P2, stream);
  }
  return static_cast<int>(e);
}

extern "C" const char* totton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
