// Overlap-save frame kernel for Hopper (sm_90a): frames [N, m] f32 ->
// output blocks [N, block] f32, the even/odd interleave written in place.
//
// Replaces the Pallas kernel totton_tpu/experimental/pallas_kernels.py
// (_fused_kernel, :284-317; pallas_call at :355), which kept one whole frame
// in TPU VMEM and ran one frame per grid program. On this card a frame's
// half-size inverse alone (h = 65536 complex f32 = 512 KB at 16x/80k) is
// more than twice the 227 KB of shared memory a block can use, and one
// frame per block leaves the product's row dimension empty. So the frame is
// split over four launches of one batched complex-GEMM template, each with
// MANY frames along its row dimension:
//
//   F1  forward stage 1:  B[n,k1,q]  = tw_m[k1,q] * sum_p x[n, p*Q+q] W_P[p,k1]
//   F2  forward stage 2:  X[n, k]    = (g[k] *) sum_q B[n,k1,q] W_Q[q,k2],
//                         k = k2*P + k1, stored q2-major for I1
//   I1  inverse stage 1:  per q2,   C[n,q2,k1'] = (tw_h *) sum_s X[n, s*Q2+q2] W1[q2][s,k1']
//                         absorbed (ratio >= 4): W1 = GW, the filter, the
//                         spectrum tiling and the inter-stage twiddle folded
//                         in once per filter swap; folded (2x): W1 = W_P2^+,
//                         the filter multiplied in F2 and tw_h applied here;
//                         ratio 1 (h = m/2): the folded form, but Z = E*G1 +
//                         E2*G2 reads both halves of the spectrum, so F2
//                         multiplies bin k by g[k] = (G1 | G2)[k] and I1's
//                         loader sums bins k and k + h: with k = s*Q2 + q2,
//                         k + h = (s + P2)*Q2 + q2, the same q2 row of X at
//                         s + P2 (depth P2, row stride r = 2*P2)
//   I2  inverse stage 2:  z[n, j] = sum_q2 C[n,q2,k1'] W_Q2^+[q2, k2'] only for
//                         the kept columns k2' >= j0 / P2 (the overlap region
//                         is never computed); out[n, 2(j-j0)+e] written
//                         directly (no trim pass, no interleave pass)
//
// What bounds it: all four products are fp32 FMA on the CUDA cores (no
// tensor cores, no TF32: TF32 keeps about three decimal digits and the
// signal path is gated at > 125 dB): 1334 FLOP per output sample at
// 16x/80k, most of it in I1 and I2. The scratch X and C make one round trip
// through device memory (C is 8*h bytes per frame), so every epilogue
// stores along its contiguous index (kRowFast) — a strided C once cost
// more than I1's arithmetic. Each launch is a 64x64 complex tile per block
// (4x4 complex accumulators per thread, summed in two levels for accuracy)
// staged through 8 KB of shared memory: simple and right first;
// double buffering, wgmma/3xTF32 and fusing I1 into I2 are later work.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // complex rows per block tile
constexpr int BN = 64;   // complex cols per block tile
constexpr int BK = 8;    // complex depth per shared-memory stage
constexpr int NT = 256;  // threads per block: 16 x 16, each 4 x 4 outputs

typedef long long i64;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// ---- operand loaders: (batch, row|k, k|col) -> complex value ------------

// F1's A: real frames, row = n*Q + q, k = p -> x[n*m + p*Q + q].
struct FrameLoader {
  const float* x;
  int m, Q;
  static constexpr bool kRowFast = true;
  static constexpr bool kRealA = true;  // imaginary part is zero
  __device__ float2 operator()(int, int row, int k) const {
    const i64 n = row / Q;
    const int q = row - (int)n * Q;
    return make_float2(x[n * m + (i64)k * Q + q], 0.f);
  }
};

// Row-major complex rows: p[bat*sb + row*ld + k].
struct RowLoader {
  const float2* p;
  i64 sb;
  int ld;
  static constexpr bool kRowFast = false;
  static constexpr bool kRealA = false;
  __device__ float2 operator()(int bat, int row, int k) const {
    return p[bat * sb + (i64)row * ld + k];
  }
};

// I1's A at ratio 1: the two halves of the spectrum summed,
// p[bat*sb + row*ld + k] + p[bat*sb + row*ld + k + half] (no two threads
// write one value, so no atomics).
struct HalfSumLoader {
  const float2* p;
  i64 sb;
  int ld, half;
  static constexpr bool kRowFast = false;
  static constexpr bool kRealA = false;
  __device__ float2 operator()(int bat, int row, int k) const {
    const float2* a = p + bat * sb + (i64)row * ld + k;
    const float2 lo = a[0];
    const float2 hi = a[half];
    return make_float2(lo.x + hi.x, lo.y + hi.y);
  }
};

// I2's A: C stored [n][q2][k1'], row = n*P2 + k1' (P2 = 1 << p2_shift),
// k = q2 -> c[(n*Q2 + q2)*P2 + k1']; consecutive rows are contiguous.
struct InvStage2Loader {
  const float2* c;
  int p2_shift, Q2;
  static constexpr bool kRowFast = true;
  static constexpr bool kRealA = false;
  __device__ float2 operator()(int, int row, int k) const {
    const i64 n = row >> p2_shift;
    const int k1 = row & ((1 << p2_shift) - 1);
    return c[((n * Q2 + k) << p2_shift) + k1];
  }
};

// Right operand, column-contiguous: p[bat*sb + k*ld + col].
struct ColLoader {
  const float2* p;
  i64 sb;
  int ld;
  __device__ float2 operator()(int bat, int k, int col) const {
    return p[bat * sb + (i64)k * ld + col];
  }
};

// ---- epilogues: (batch, row, col, value) -> store -----------------------

// Each epilogue says which of its indices is contiguous in memory:
// kRowFast puts neighbouring threads on neighbouring rows, else columns,
// so that a warp's stores coalesce.

// F1: row = n*Q + q, col = k1 -> B[n, k1, q] = v * tw_m[k1, q].
struct FwdStage1Store {
  float2* b;
  const float2* tw;
  int m, Q;
  static constexpr bool kRowFast = true;
  __device__ void operator()(int, int row, int col, float2 v) const {
    const i64 n = row / Q;
    const int q = row - (int)n * Q;
    b[n * m + (i64)col * Q + q] = cmul(v, tw[col * Q + q]);
  }
};

// F2: row = n*P + k1, col = k2 -> natural bin k = k2*P + k1 = s*Q2 + q2;
// X[n, q2, s] = v (* g[k]).
struct FwdStage2Store {
  float2* x;
  const float2* g;  // folded path: filter G in natural order (ratio 1:
                    // G1 then G2, m bins), else null
  int m, P, Q2, r;
  static constexpr bool kRowFast = false;
  __device__ void operator()(int, int row, int col, float2 v) const {
    const i64 n = row / P;
    const int k1 = row - (int)n * P;
    const int k = col * P + k1;
    if (g != nullptr) v = cmul(v, g[k]);
    const int s = k / Q2;
    const int q2 = k - s * Q2;
    x[n * m + (i64)q2 * r + s] = v;
  }
};

// I1: batch = q2, row = n, col = k1' -> C[n, q2, k1'] = v (* tw_h[k1', q2]).
struct InvStage1Store {
  float2* c;
  const float2* tw;  // folded path: inverse inter-stage twiddle, else null
  int P2, Q2;
  static constexpr bool kRowFast = false;
  __device__ void operator()(int q2, int row, int col, float2 v) const {
    if (tw != nullptr) v = cmul(v, tw[col * Q2 + q2]);
    c[((i64)row * Q2 + q2) * P2 + col] = v;
  }
};

// I2: row = n*P2 + k1', col = k2' -> j = (k2_0 + k2')*P2 + k1';
// out[n, 2(j - j0) + e] for j >= j0.
struct OutStore {
  float* out;
  int p2_shift, block, j0, k2_0;
  static constexpr bool kRowFast = true;
  __device__ void operator()(int, int row, int col, float2 v) const {
    const i64 n = row >> p2_shift;
    const int k1 = row & ((1 << p2_shift) - 1);
    const int P2 = 1 << p2_shift;
    const int j = (k2_0 + col) * P2 + k1 - j0;
    if (j < 0) return;
    float* o = out + n * block + 2 * (i64)j;
    o[0] = v.x;
    o[1] = v.y;
  }
};

// ---- the batched complex GEMM ------------------------------------------
// C[bat][row][col] = sum_k A[bat][row][k] * B[bat][k][col], complex fp32;
// grid = (ceil(M/BM), ceil(N/BN), batches).
template <class LA, class LB, class ST>
__global__ void __launch_bounds__(NT) cgemm(LA la, LB lb, ST st,
                                            int M, int N, int K) {
  __shared__ float2 As[BK][BM];
  __shared__ float2 Bs[BK][BN];
  const int tid = threadIdx.x;
  // This thread's outputs: rows tr + 16*i, columns tc + 16*j.
  const int tr = ST::kRowFast ? tid % 16 : tid / 16;
  const int tc = ST::kRowFast ? tid / 16 : tid % 16;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int bat = blockIdx.z;

  float2 acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = make_float2(0.f, 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / NT; ++l) {
      const int idx = tid + l * NT;
      int r, kk;
      if (LA::kRowFast) {
        r = idx % BM;
        kk = idx / BM;
      } else {
        kk = idx % BK;
        r = idx / BK;
      }
      const int gr = row0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? la(bat, gr, gk) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int l = 0; l < (BK * BN) / NT; ++l) {
      const int idx = tid + l * NT;
      const int c = idx % BN;
      const int kk = idx / BN;
      const int gc = col0 + c;
      const int gk = k0 + kk;
      Bs[kk][c] = (gc < N && gk < K) ? lb(bat, gk, gc) : make_float2(0.f, 0.f);
    }
    __syncthreads();
    // Two-level sum: each BK-deep stage sums into fresh partials that are
    // then added to the accumulators, so rounding error grows with
    // K / BK + BK terms instead of K (K = 256 in I2).
    float2 part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = make_float2(0.f, 0.f);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float2 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][tr + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float2 s = part[i][j];
          s.x = fmaf(a[i].x, b[j].x, s.x);
          s.y = fmaf(a[i].x, b[j].y, s.y);
          if (!LA::kRealA) {
            s.x = fmaf(-a[i].y, b[j].y, s.x);
            s.y = fmaf(a[i].y, b[j].x, s.y);
          }
          part[i][j] = s;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j].x += part[i][j].x;
        acc[i][j].y += part[i][j].y;
      }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = row0 + tr + 16 * i;
      const int gc = col0 + tc + 16 * j;
      if (gr < M && gc < N) st(bat, gr, gc, acc[i][j]);
    }
}

template <class LA, class LB, class ST>
void launch(LA la, LB lb, ST st, int M, int N, int K, int batches,
            cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, batches);
  cgemm<LA, LB, ST><<<grid, NT, 0, stream>>>(la, lb, st, M, N, K);
}

}  // namespace

extern "C" int totton_fused_frames(
    const float* frames, float* out,
    float2* scratch_b, float2* scratch_x, float2* scratch_c,
    const float2* w_p, const float2* tw_m, const float2* w_q,
    const float2* g_nat, const float2* w1, long long w1_batch_stride,
    const float2* tw_h, const float2* w2,
    int n_frames, int m, int P, int Q, int P2, int Q2, int r,
    int kept, int k2_0, int j0, int block, int p2_shift, int halves,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // F1: rows (n, q), depth p, cols k1.
  launch(FrameLoader{frames, m, Q}, ColLoader{w_p, 0, P},
         FwdStage1Store{scratch_b, tw_m, m, Q},
         n_frames * Q, P, P, 1, stream);
  // F2: rows (n, k1), depth q, cols k2.
  launch(RowLoader{scratch_b, 0, Q}, ColLoader{w_q, 0, Q},
         FwdStage2Store{scratch_x, g_nat, m, P, Q2, r},
         n_frames * P, Q, Q, 1, stream);
  // I1: batch q2, rows n, depth s (r = m / Q2; P2 at ratio 1), cols k1'.
  if (halves) {
    launch(HalfSumLoader{scratch_x, r, m, P2}, ColLoader{w1, 0, P2},
           InvStage1Store{scratch_c, tw_h, P2, Q2},
           n_frames, P2, P2, Q2, stream);
  } else {
    launch(RowLoader{scratch_x, r, m}, ColLoader{w1, w1_batch_stride, P2},
           InvStage1Store{scratch_c, tw_h, P2, Q2},
           n_frames, P2, r, Q2, stream);
  }
  // I2: rows (n, k1'), depth q2, kept cols k2'.
  launch(InvStage2Loader{scratch_c, p2_shift, Q2}, ColLoader{w2, 0, kept},
         OutStore{out, p2_shift, block, j0, k2_0},
         n_frames * P2, kept, Q2, 1, stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* totton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
