// Overlap-save frame kernel for Hopper (sm_90a): frames [N, m] f32 ->
// output blocks [N, block] f32, the even/odd interleave written in place.
//
// Replaces the Pallas kernel totton_tpu/experimental/pallas_kernels.py
// (_fused_kernel, :284-317; pallas_call at :355), which kept one whole frame
// in TPU VMEM and ran its DFT stages as dense products on the matrix unit.
// On this card the dense products cost 1334 FLOP per output sample at
// 16x/80k on the CUDA cores; radix FFTs cost about 91. So every transform
// here is a batch of short Stockham FFTs (radix 8, then one radix-2,
// radix-4 or radix-16 pass) run in shared memory. Two plans, chosen by the
// geometry:
//
// RESIDENT, h = fft_size/2 <= 8192 (ratio 1 and the 8k bank): one launch,
// fft_resident<M, H>. A block holds TB frames whole in shared memory, as
// the Pallas kernel held one in VMEM, and device memory sees each frame
// read once and each block written once:
//   the M = m/2 point FFT of z[i] = x[2i] + i x[2i+1], untangled in place
//     into X[0 .. M] (M + 1 bins; X[m - j] = conj(X[j]) gives the rest);
//   Z[k] = X[k mod m] * G[k]            (ratio >= 2; G = G1 + G2)
//   Z[k] = X[k] G1[k] + X[k + h] G2[k]  (ratio 1, h = M);
//   the h-point inverse FFT of Z, and out[n, 2(j - j0) + {0, 1}] = z[j]
//     for j >= j0 only (the overlap region is never stored).
// At 2x/8k a frame takes (4104 + 8192) x 9/8 x 8 bytes = 108 KB of a
// block's 227 KB (the layout pads one slot in 9); at 16x/8k 77 KB.
//
// THREE LAUNCHES, h > 8192 (the 80k bank): the frame is split over launches
// because its half-size inverse (h = 65536 complex f32 = 512 KB at
// 16x/80k) does not fit a block's 227 KB:
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
// Every three-launch launch is one template, fft_stage: a block holds TB
// transforms of length N in shared memory, element i of transform t at
// sm[i*S + t] with S = TB + 1 (the pad keeps the column reads and writes
// free of bank conflicts), each thread holds 8 values per pass, and a
// loader and a store functor map (transform, element) to device memory
// with neighbouring threads on neighbouring addresses (kFastT says which
// index is contiguous). fft_resident runs the same passes on a padded
// layout (Padded), its first pass reading the frame or forming Z and its
// last storing the block, with its twiddles laid out pass by pass
// (PassTables). Twiddles come from tables built in float64 on the host
// and stored as f32 (forward W_N^e; an inverse pass multiplies by the
// conjugate).
//
// What bounds it: the bytes. At 16x/80k (P2 = Q2 = 256) a frame moves
// 32 KB in, X (64 KB) and C (512 KB) out and back, 204 KB out: about
// 1.4 MB against 4.7 MFLOP of FFT arithmetic, so the scratch round trips,
// not the FMAs, set the time; I1 also reads G and the [Q2, P2] twiddle
// table (512 KB each) from L2 for every frame. The resident plan has no
// scratch: what is left is the frame and the block, G and the tables
// (L2-resident across frames), and the passes' shared-memory traffic.
// fp32 throughout, no tensor cores and no TF32 (the signal path is gated
// at > 125 dB); FFT rounding error grows with log N.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing, returns the first CUDA error (cudaGetLastError after each
// launch).

#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

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
__device__ __forceinline__ float2 conj(float2 a) {
  return make_float2(a.x, -a.y);
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

// a * W_16^E, E = 1 or 3: (cos, -+sin)(E pi / 8).
template <bool INV, int E>
__device__ __forceinline__ float2 mul_w16(float2 a) {
  const float c = E == 1 ? 0.92387953251128676f : 0.38268343236508977f;
  const float s = E == 1 ? 0.38268343236508977f : 0.92387953251128676f;
  return INV ? make_float2(a.x * c - a.y * s, a.y * c + a.x * s)
             : make_float2(a.x * c + a.y * s, a.y * c - a.x * s);
}

template <int R, bool INV>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 16) {
    // 4 x 4: DFT_4 over v[q + 4p] for each q, a[q][k1]; times W_16^{q k1};
    // DFT_4 over q for each k1 gives X[k1 + 4 k2].
    float2 a[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q][0] = v[q];
      a[q][1] = v[q + 4];
      a[q][2] = v[q + 8];
      a[q][3] = v[q + 12];
      dft4<INV>(a[q][0], a[q][1], a[q][2], a[q][3]);
    }
    a[1][1] = mul_w16<INV, 1>(a[1][1]);
    a[1][2] = mul_w8<INV>(a[1][2]);
    a[1][3] = mul_w16<INV, 3>(a[1][3]);
    a[2][1] = mul_w8<INV>(a[2][1]);
    a[2][2] = mul_w4<INV>(a[2][2]);
    a[2][3] = mul_w4<INV>(mul_w8<INV>(a[2][3]));
    a[3][1] = mul_w16<INV, 3>(a[3][1]);
    a[3][2] = mul_w4<INV>(mul_w8<INV>(a[3][2]));
    const float2 w9 = mul_w16<INV, 1>(a[3][3]);  // W_16^9 = -W_16^1
    a[3][3] = make_float2(-w9.x, -w9.y);
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      dft4<INV>(a[0][k1], a[1][k1], a[2][k1], a[3][k1]);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) v[k1 + 4 * k2] = a[k2][k1];
    }
  } else if constexpr (R == 2) {
    const float2 t = v[0];
    v[0] = cadd(t, v[1]);
    v[1] = csub(t, v[1]);
  } else if constexpr (R == 4) {
    dft4<INV>(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(R == 8, "radix 2, 4, 8 or 16");
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

// Where element i of transform t sits in shared memory. fft_stage:
// sm[i*S + t]. fft_resident: e = i*TB + t plus one pad slot after every
// 8, so that a pass's stores of stride 8 (NS = 1) and of 8-runs 64 apart
// (NS = 8) fall on distinct banks even with one transform a block.
template <int S>
struct Strided {
  __device__ static int at(int i, int t) { return i * S + t; }
};
template <int TB>
struct Padded {
  __device__ static int at(int i, int t) {
    const int e = i * TB + t;
    return e + (e >> 3);
  }
  // Slots that hold n elements of TB transforms (n * TB a multiple of 8).
  static constexpr int slots(int n) { return n * TB + n * TB / 8; }
};

// Transform t of a block in shared memory, element i at sm[L::at(i, t)]:
// read as s(i), written as s(i, v).
template <class L>
struct Smem {
  float2* sm;
  int t;
  __device__ float2 operator()(int i) const { return sm[L::at(i, t)]; }
  __device__ void operator()(int i, float2 v) const { sm[L::at(i, t)] = v; }
};

// Where a pass finds its twiddle W_{NS R}^{k r}, k < NS, r < R, and how
// many entries of the table its pass takes. WholeTable (fft_stage): the
// table of W_N^e, e < N, at e = k r N/(NS R); from NS = 64 a warp's load
// of one r touches a line a thread. PassTables (fft_resident): pass NS's
// [R - 1, NS] block of W_{NS R}^{k r} after the earlier passes' blocks
// (N - 8 entries in all), neighbouring k on neighbouring addresses. The
// values are the same floats.
struct WholeTable {
  template <int N, int R, int NS>
  __device__ static int at(int k, int r) { return k * r * (N / (NS * R)); }
  template <int R, int NS>
  static constexpr int kSize = 0;
};
struct PassTables {
  template <int N, int R, int NS>
  __device__ static int at(int k, int r) { return (r - 1) * NS + k; }
  template <int R, int NS>
  static constexpr int kSize = NS > 1 ? (R - 1) * NS : 0;
};

// One Stockham pass of radix R over sub-transforms of size NS of an
// N-point transform, V values a thread (fft_stage 8; fft_resident 8 or
// 16), its twiddles from tw as TW places them:
//   v[r] = d[j + r*N/R] * W_{NS*R}^{(j mod NS) r};  v = DFT_R(v);
//   d[(j / NS)*NS*R + (j mod NS) + r*NS] = v[r].
// After the passes (NS = 1, 8, 64, ...) the transform is in natural order.
// in(i) reads element i and out(i, v) writes it: the block's transform in
// shared memory (of type Mid) in place, or a source a first pass reads
// instead, or a sink a last pass writes instead. A pass that reads and
// writes Mid syncs between its reads and its writes; one that writes Mid
// syncs after its writes. A thread that is not `active` (a block shaped
// for a longer transform) only meets the barriers.
template <int N, int V, bool INV, int R, int NS, class TW, class Mid,
          class In, class Out>
__device__ __forceinline__ void radix_pass(In in, Out out,
                                           const float2* __restrict__ tw,
                                           int jf, bool active) {
  constexpr int TPT = N / V;  // threads per transform
  constexpr int NB = V / R;   // butterflies per thread
  constexpr bool kWritesMid = std::is_same_v<Out, Mid>;
  float2 v[NB][R];
  if (active) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int j = jf + b * TPT;
#pragma unroll
      for (int r = 0; r < R; ++r) v[b][r] = in(j + r * (N / R));
    }
  }
  if constexpr (kWritesMid && std::is_same_v<In, Mid>) __syncthreads();
  if (active) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int j = jf + b * TPT;
      const int k = j & (NS - 1);
      if constexpr (NS > 1) {
#pragma unroll
        for (int r = 1; r < R; ++r) {
          const float2 w = __ldg(tw + TW::template at<N, R, NS>(k, r));
          v[b][r] = INV ? cmulc(v[b][r], w) : cmul(v[b][r], w);
        }
      }
      dft<R, INV>(v[b]);
      const int d = (j / NS) * NS * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) out(d + r * NS, v[b][r]);
    }
  }
  if constexpr (kWritesMid) __syncthreads();
}

// The passes of an N-point FFT: radix 8 while N/NS >= 8, then one radix
// 2 or 4, or, with 16 values a thread, radix 16 where N/NS = 16 (8192 =
// 8^3 x 16 in four passes, not five). The first reads `first`, the last
// writes `last`, the others work on `mid` in place (fft_stage passes mid
// for all three).
template <int N, int V, bool INV, class TW, int NS = 1, class First,
          class Mid, class Last>
__device__ __forceinline__ void fft_passes(First first, Mid mid, Last last,
                                           const float2* __restrict__ tw,
                                           int jf, bool active) {
  if constexpr (NS < N) {
    constexpr int R = (V == 16 && N / NS == 16) ? 16
                      : (N / NS >= 8)           ? 8
                                                : N / NS;
    constexpr bool kLast = NS * R == N;
    if constexpr (NS == 1) {
      radix_pass<N, V, INV, R, NS, TW, Mid>(first, mid, tw, jf, active);
    } else if constexpr (kLast) {
      radix_pass<N, V, INV, R, NS, TW, Mid>(mid, last, tw, jf, active);
    } else {
      radix_pass<N, V, INV, R, NS, TW, Mid>(mid, mid, tw, jf, active);
    }
    fft_passes<N, V, INV, TW, NS * R>(first, mid, last,
                                      tw + TW::template kSize<R, NS>, jf,
                                      active);
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
  const Smem<Strided<TL::S>> mid{sm, tid % TL::TB};
  fft_passes<N, 8, INV, WholeTable>(mid, mid, mid, tw, tid / TL::TB, true);
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
    xn[half + k] = conj(untangle(zr, z, __ldg(wm + half - k)));
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

// ---- the resident plan: a whole frame in one block -----------------------

// The resident block for (M, H): Tile<H>'s TB frames (H >= M at every
// ratio), V values a thread a pass (16 from H = 4096: half the threads,
// two butterflies each), the Padded<TB> layout; X takes XN >= M + 1
// slots a frame, so that Z's region starts on a group of 8. Registers are
// held to 2 blocks an SM (__launch_bounds__), as the shared memory is at
// 2x/8k.
template <int M, int H>
struct Resident {
  static constexpr int TB = Tile<H>::TB, V = H >= 4096 ? 16 : 8;
  static constexpr int NT = TB * H / V;
  using L = Padded<TB>;
  static constexpr int XN = M + (TB >= 8 ? 1 : 8 / TB);
  static constexpr int XS = L::slots(XN);  // Z's offset
  static constexpr int SMEM = L::slots(XN + H) * (int)sizeof(float2);
};

// Frames N0 .. N0 + TB - 1 of `total` (m = 2M samples each; h = H, ratio 1
// when H == M), frame t = tid % TB on the threads tid: element i at
// sx[L::at(i, t)] (the forward, then X[0 .. M]) and sz[L::at(i, t)] (Z,
// then the inverse). The forward FFT runs on the first TB * M / V threads,
// its first pass reading the frame from device memory; the inverse's first
// pass forms Z as it reads, with I1's products in I1's order
// (InvStage1Load), the bins above M read as conj(X[m - j]), bit for bit X
// as SpecStore stores it; its last pass stores the kept columns j >= j0
// interleaved (OutStore). tw_fwd: the M-point FFT's PassTables (M - 8
// entries) then W_m^j, j = 0 .. M; tw_inv: the H-point FFT's PassTables.
template <int M, int H>
__global__ void __launch_bounds__(Resident<M, H>::NT, 2)
    fft_resident(const float* __restrict__ frames, float* __restrict__ out,
                 const float2* __restrict__ g,
                 const float2* __restrict__ tw_fwd,
                 const float2* __restrict__ tw_inv, i64 total, int block,
                 int j0) {
  using RB = Resident<M, H>;
  using L = typename RB::L;
  constexpr int TB = RB::TB, V = RB::V, NT = RB::NT, m = 2 * M;
  extern __shared__ float2 sm[];
  const int tid = threadIdx.x, t = tid % TB, jf = tid / TB;
  const i64 n = (i64)blockIdx.x * TB + t;
  const bool live = n < total;
  const Smem<L> sx{sm, t}, sz{sm + RB::XS, t};
  const FrameLoad ld{frames, m};
  auto frame = [&](int i) {
    return live ? ld(n, i) : make_float2(0.f, 0.f);
  };
  fft_passes<M, V, false, PassTables>(frame, sx, sx, tw_fwd, jf, jf < M / V);
  // Untangle in place, one (k, M - k) pair a thread: slot k = X[k], slot
  // M - k = X[M - k], and slot M = conj(X[M]) (the value SpecStore stores
  // at M, read by Z at k mod m = M).
  const float2* wm = tw_fwd + (M - 8);
  constexpr int kPairs = TB * (M / 2 + 1);
#pragma unroll
  for (int l = 0; l < (kPairs + NT - 1) / NT; ++l) {
    const int e = tid + l * NT;
    if (e >= kPairs) break;
    const Smem<L> x{sm, e % TB};
    const int k = e / TB;
    const float2 z = x(k), zr = x((M - k) & (M - 1));
    x(k, SpecStore::untangle(z, zr, __ldg(wm + k)));
    if (k == 0) {
      x(M, conj(SpecStore::untangle(z, z, __ldg(wm + M))));
    } else if (k < M / 2) {
      x(M - k, SpecStore::untangle(zr, z, __ldg(wm + M - k)));
    }
  }
  __syncthreads();
  auto spectrum = [&](int k) {
    if constexpr (H == M) {
      const float2 hi = k == 0 ? sx(M) : conj(sx(M - k));
      return cadd(cmul(sx(k), __ldg(g + k)), cmul(hi, __ldg(g + k + H)));
    } else {
      const int j = k & (m - 1);
      return cmul(j <= M ? sx(j) : conj(sx(m - j)), __ldg(g + k));
    }
  };
  float2* o = reinterpret_cast<float2*>(out + (live ? n : 0) * block);
  auto store = [&](int j, float2 v) {
    if (live && j >= j0) o[j - j0] = v;
  };
  fft_passes<H, V, true, PassTables>(spectrum, sz, store, tw_inv, jf, true);
}

// ---- launches ------------------------------------------------------------

// K<<<blocks, threads, smem, stream>>>(args...) on the current device,
// the dynamic shared memory above 48 KB allowed first (once per kernel and
// device: the attribute call costs about as much as the launch).
template <auto K, class... A>
cudaError_t launch(i64 blocks, int threads, int smem, cudaStream_t stream,
                   A... args) {
  static std::atomic<unsigned long long> allowed{0};
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    const unsigned long long bit = 1ull << (dev & 63);
    if (e == cudaSuccess && !(allowed.load() & bit)) {
      e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e == cudaSuccess) allowed.fetch_or(bit);
    }
    if (e != cudaSuccess) return e;
  }
  K<<<(unsigned)blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// `device` current for a scope (the card the caller's tensors are on),
// then the caller's again.
struct OnDevice {
  int prev = 0, dev;
  cudaError_t err;
  explicit OnDevice(int device) : dev(device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  }
  ~OnDevice() {
    if (prev != dev) cudaSetDevice(prev);
  }
};

template <int N, bool INV, class LD, class ST>
cudaError_t run(LD ld, ST st, const float2* tw, i64 total,
                cudaStream_t stream) {
  using TL = Tile<N>;
  return launch<fft_stage<N, INV, LD, ST>>((total + TL::TB - 1) / TL::TB,
                                          TL::NT, TL::SMEM, stream, ld, st, tw,
                                          total);
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

// The resident plan's envelope (ops/fused_frames.py RESIDENT_*): h = H in
// [256, 8192], ratio H / M in 1, 2, 4, 8, 16 (1 when H == M).
constexpr int kResidentMinH = 256, kResidentMaxH = 8192;
constexpr int kResidentMaxRatio = 16;

template <int H, int M = H>
cudaError_t run_resident(int half, const float* frames, float* out,
                         const float2* g, const float2* tw_fwd,
                         const float2* tw_inv, i64 total, int block, int j0,
                         cudaStream_t stream) {
  if (half == M) {
    using RB = Resident<M, H>;
    return launch<fft_resident<M, H>>((total + RB::TB - 1) / RB::TB, RB::NT,
                                      RB::SMEM, stream, frames, out, g, tw_fwd,
                                      tw_inv, total, block, j0);
  }
  if constexpr (H / M < kResidentMaxRatio) {
    return run_resident<H, M / 2>(half, frames, out, g, tw_fwd, tw_inv, total,
                                  block, j0, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <int H = kResidentMinH>
cudaError_t dispatch_resident(int h, int half, const float* frames,
                              float* out, const float2* g,
                              const float2* tw_fwd, const float2* tw_inv,
                              i64 total, int block, int j0,
                              cudaStream_t stream) {
  if (h == H) {
    return run_resident<H>(half, frames, out, g, tw_fwd, tw_inv, total, block,
                           j0, stream);
  }
  if constexpr (H < kResidentMaxH) {
    return dispatch_resident<2 * H>(h, half, frames, out, g, tw_fwd, tw_inv,
                                    total, block, j0, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// The resident plan, one launch: frames [n_frames, m] -> out [n_frames,
// block], block = 2 (h - j0). g: G [h] (ratio >= 2) or G1 then G2 [2h]
// (ratio 1, h = m/2: `halves`). tw_fwd: the m/2-point FFT's per-pass
// twiddles (PassTables, m/2 - 8 entries) then W_m^j, j = 0 .. m/2;
// tw_inv: the h-point FFT's (h - 8). No scratch. Launched on `stream` of
// `device`.
extern "C" int totton_resident_frames(
    const float* frames, float* out, const float2* g, const float2* tw_fwd,
    const float2* tw_inv, long long n_frames, int m, int h, int block, int j0,
    int halves, int device, void* stream_ptr) {
  if (halves != (m / 2 == h) || block != 2 * (h - j0) || j0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return static_cast<int>(dispatch_resident(
      h, m / 2, frames, out, g, tw_fwd, tw_inv, n_frames, block, j0,
      static_cast<cudaStream_t>(stream_ptr)));
}

// The three-launch plan: frames [n_frames, m] -> out [n_frames, block].
// Scratch: x [n_frames, m] complex; b [n_frames, m] complex (two-launch
// forward only, else null); c [n_frames, h] complex. Tables: tw_fwd the
// forward W_N^e of the forward transform (fused: W_{m/2}^e then W_m^j,
// j = 0 .. m/2; else W_P then W_Q), tw_m [P, Q] (two-launch only), tw_p2
// / tw_q2 the forward W_P2^e / W_Q2^e, tw_h [Q2, P2] = W_h^{+k1' q2}.
// Launched on `stream` of `device`.
extern "C" int totton_fused_frames(
    const float* frames, float* out, float2* scratch_b, float2* scratch_x,
    float2* scratch_c, const float2* g, const float2* tw_fwd,
    const float2* tw_m, const float2* tw_p2, const float2* tw_q2,
    const float2* tw_h, long long n_frames, int m, int P,
    int Q, int P2, int Q2, int block, int j0, int fused, int halves,
    int device, void* stream_ptr) {
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
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
