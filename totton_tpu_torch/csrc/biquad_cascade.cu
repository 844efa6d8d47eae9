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
// a * y and the sum with s2 on their own; the update (`tdf2` below) is
// written out in those intrinsics (__fmaf_rn, __fmul_rn, __fadd_rn), which
// nvcc neither contracts nor reorders. Each band still sees its samples in
// order and each sample its bands in order; only the schedule below is
// this card's, so the kernel computes the plain version's float32 values.
//
// What bounds it: latency, not bytes or FLOPs. Sample t + 1 needs each
// band's state from sample t, so the recursion is a chain of dependent
// operations: each band's own y -> a1 * y -> fma -> + s2 -> y is four a
// sample, and the bands pipeline behind each other, so no schedule of
// this arithmetic finishes in fewer than about 4T + S dependent
// operations per channel.
//
// Design: a band-per-lane wavefront. One warp per channel (one block of
// 32 threads); lane i holds band i's coefficients and (s1, s2) in
// registers, so one launch takes up to MAX_BANDS = 32 bands, and lanes at
// or past the launch's band count stay idle. The samples go in tiles of
// TILE = 32. At step k lane i filters tile k - i: it reads the tile that
// lane i - 1 wrote at step k - 1 from shared memory, runs the 32-sample
// recursion in registers and writes its outputs to its own slot; a
// __syncwarp() between steps hands the slots on. Lane 0 reads the x tile
// (times the preamp) that the warp staged in slot 0 one step earlier; the
// warp loads each x tile with one coalesced 128-byte load three steps
// before band 0 needs it (two tiles in flight in registers), so band 0
// never waits on device memory. The last band's tile is y: the next step
// stores it with one coalesced 128-byte store. So a lane's chain in a step
// is its own recursion, 4 dependent operations a sample, and a channel
// takes ceil(T / 32) + S - 1 steps, not the T x S chain of a thread that
// walks every band of a sample before the next sample.
//
// The slots are double-buffered (written in step k, read in step k + 1)
// and padded to a stride of TILE + 1 floats: lane i reading element j of
// slot i - 1 while every lane does the same is then 32 different banks,
// where a stride of 32 would put all 32 lanes on one bank. A partial last
// tile runs only its real samples, so each band's final state is its
// state after sample T - 1; a lane writes its state after its last tile.
//
// More than 32 bands run as consecutive launches (the wrapper's groups):
// a launch takes its band offset and the total band count, reads its
// slice of state_in and writes its slice of state_out ([C, S, 2] each),
// and later groups filter y in place (a lane loads each element of x
// steps before it stores the same element of y).
//
// Interface (plain C, loaded with ctypes): every pointer is device memory
// on the current card; the launch goes to `stream_ptr`; returns the first
// CUDA error (cudaGetLastError after the launch), 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_BANDS = 32;      // one band a lane of the warp
constexpr int TILE = 32;           // samples a lane filters in one step
constexpr int ROW = TILE + 1;      // padded slot stride: conflict-free banks
constexpr int MAX_TILES = 1 << 30; // step indices stay 32-bit

struct Band {
  float b0, b1, b2, a1, a2, s1, s2;
};

// One sample through one band: the reference's update and roundings.
__device__ __forceinline__ float tdf2(Band& q, float v) {
  const float out = __fmaf_rn(q.b0, v, q.s1);
  q.s1 = __fadd_rn(__fmaf_rn(q.b1, v, -__fmul_rn(q.a1, out)), q.s2);
  q.s2 = __fmaf_rn(q.b2, v, -__fmul_rn(q.a2, out));
  return out;
}

// x and y may be the same array (a later group filters y in place), so
// neither is __restrict__.
__global__ void __launch_bounds__(MAX_BANDS)
cascade_kernel(const float* x, float* y, const float* __restrict__ coeffs,
               const float* __restrict__ state_in,
               float* __restrict__ state_out, float preamp, long long n,
               int bands, int band_offset, int total_bands) {
  // slot[b][0]: the staged x tile; slot[b][i + 1]: band i's output tile.
  __shared__ float slot[2][MAX_BANDS + 1][ROW];
  const int lane = threadIdx.x;
  const long long c = blockIdx.x;
  const float* xc = x + c * n;
  float* yc = y + c * n;
  const bool has_band = lane < bands;
  const long long st = (c * total_bands + band_offset + lane) * 2;
  Band q{};
  if (has_band) {
    const float* k = coeffs + 5 * (band_offset + lane);
    q = Band{k[0], k[1], k[2], k[3], k[4], state_in[st], state_in[st + 1]};
  }
  const int tiles = static_cast<int>((n + TILE - 1) / TILE);
  const int steps = tiles + bands - 1;  // the last band's last tile
  // The warp's coalesced load of x tile `tile` (zeros past the end).
  auto load_x = [&](int tile) {
    const long long t = static_cast<long long>(tile) * TILE + lane;
    return t < n ? xc[t] : 0.0f;
  };

  // Step k: stage x tile k + 1 and fetch tile k + 3 into `x_next`, filter
  // tile k - lane, store y's tile k - bands.
  auto step = [&](int k, float& x_next) {
    const int r = k & 1;
    // The last band finished y's tile at step k - 1: read it now, store it
    // after the recursion, so the read's latency hides behind it.
    const float y_out = slot[r][bands][lane];
    slot[r ^ 1][0][lane] = __fmul_rn(x_next, preamp);
    x_next = load_x(k + 3);
    const int j = k - lane;
    if (has_band && j >= 0 && j < tiles) {
      const float* in = slot[r][lane];
      float* out = slot[r ^ 1][lane + 1];
      const long long left = n - static_cast<long long>(j) * TILE;
      if (left >= TILE) {
#pragma unroll
        for (int i = 0; i < TILE; ++i) out[i] = tdf2(q, in[i]);
      } else {
        for (int i = 0; i < left; ++i) out[i] = tdf2(q, in[i]);
      }
    }
    const long long ty = static_cast<long long>(k - bands) * TILE + lane;
    if (k >= bands && ty < n) yc[ty] = y_out;
    __syncwarp();
  };

  slot[0][0][lane] = __fmul_rn(load_x(0), preamp);
  float xa = load_x(1), xb = load_x(2);
  __syncwarp();
  // Two steps an iteration, so each prefetch register is written by its
  // load and read two steps later, never moved while the load is in flight.
  for (int k = 0; k <= steps; k += 2) {
    step(k, xa);
    if (k + 1 <= steps) step(k + 1, xb);
  }
  if (has_band) {
    state_out[st] = q.s1;
    state_out[st + 1] = q.s2;
  }
}

}  // namespace

// x, y: [channels, n] float32 (y may be x); coeffs: [total_bands, 5]
// float32 rows of (b0, b1, b2, a1, a2); state_in, state_out: [channels,
// total_bands, 2] float32. Filters bands [band_offset, band_offset +
// bands), 1 <= bands <= MAX_BANDS (32, eq/iir.py's MAX_BANDS), reading
// and writing only those bands' state; 1 <= n <= MAX_TILES * TILE.
extern "C" int totton_biquad_cascade(const float* x, float* y,
                                     const float* coeffs,
                                     const float* state_in, float* state_out,
                                     float preamp, int channels, long long n,
                                     int bands, int band_offset,
                                     int total_bands, void* stream_ptr) {
  if (bands < 1 || bands > MAX_BANDS || channels < 1 || n < 1 ||
      n > static_cast<long long>(MAX_TILES) * TILE || band_offset < 0 ||
      band_offset + bands > total_bands) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cascade_kernel<<<channels, MAX_BANDS, 0,
                   static_cast<cudaStream_t>(stream_ptr)>>>(
      x, y, coeffs, state_in, state_out, preamp, n, bands, band_offset,
      total_bands);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* totton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
