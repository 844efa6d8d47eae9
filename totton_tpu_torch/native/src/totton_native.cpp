// Native host-side audio runtime: PCM conversion, interleave, SPSC ring.
//
// TPU-native equivalent of the reference's C++ middleware hot paths
// (src/alsa/alsa_common.cpp:42-127 conversions, include/io/audio_ring_buffer.h
// SPSC ring). The TPU does the DSP; this library keeps the host feeder/
// drainer threads off the Python interpreter for high-channel-count streams.
//
// Build: g++ -O3 -march=native -shared -fPIC (driven by totton_tpu.native).
// ABI: plain C functions over raw pointers, bound via ctypes.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

// ---------------------------------------------------------------- PCM

// Scale/clamp constants identical to the reference (alsa_common.cpp:96-117).
static constexpr float kS16Scale = 32768.0f;
static constexpr float kS24Scale = 8388608.0f;
static constexpr float kS32Scale = 2147483648.0f;
static constexpr float kS16ClampHi = 0.9999695f;
static constexpr float kS24ClampHi = 0.9999999f;

void pcm_s16_to_float(const int16_t* src, float* dst, int64_t n) {
  const float scale = 1.0f / kS16Scale;
  for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<float>(src[i]) * scale;
}

void pcm_s32_to_float(const int32_t* src, float* dst, int64_t n) {
  const float scale = 1.0f / kS32Scale;
  for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<float>(src[i]) * scale;
}

void pcm_s24_to_float(const uint8_t* src, float* dst, int64_t n) {
  const float scale = 1.0f / kS24Scale;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = src + i * 3;
    int32_t v = static_cast<int32_t>(p[0]) | (static_cast<int32_t>(p[1]) << 8) |
                (static_cast<int32_t>(p[2]) << 16);
    if (v & 0x00800000) v |= static_cast<int32_t>(0xFF000000);
    dst[i] = static_cast<float>(v) * scale;
  }
}

static inline float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

void float_to_pcm_s16(const float* src, int16_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float c = clampf(src[i], -1.0f, kS16ClampHi);
    dst[i] = static_cast<int16_t>(c * kS16Scale);
  }
}

void float_to_pcm_s32(const float* src, int32_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float c = clampf(src[i], -1.0f, kS24ClampHi);
    double scaled = static_cast<double>(c) * static_cast<double>(kS32Scale);
    if (scaled > 2147483647.0) scaled = 2147483647.0;
    dst[i] = static_cast<int32_t>(scaled);
  }
}

void float_to_pcm_s24(const float* src, uint8_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float c = clampf(src[i], -1.0f, kS24ClampHi);
    int32_t v = static_cast<int32_t>(c * kS24Scale);
    if (v > 0x7FFFFF) v = 0x7FFFFF;
    uint8_t* p = dst + i * 3;
    p[0] = static_cast<uint8_t>(v & 0xFF);
    p[1] = static_cast<uint8_t>((v >> 8) & 0xFF);
    p[2] = static_cast<uint8_t>((v >> 16) & 0xFF);
  }
}

// -------------------------------------------------------- interleave

// [channels, frames] planar -> frames*channels interleaved.
void interleave_f32(const float* src, float* dst, int64_t channels,
                    int64_t frames) {
  for (int64_t c = 0; c < channels; ++c) {
    const float* in = src + c * frames;
    float* out = dst + c;
    for (int64_t i = 0; i < frames; ++i) out[i * channels] = in[i];
  }
}

void deinterleave_f32(const float* src, float* dst, int64_t channels,
                      int64_t frames) {
  for (int64_t c = 0; c < channels; ++c) {
    const float* in = src + c;
    float* out = dst + c * frames;
    for (int64_t i = 0; i < frames; ++i) out[i] = in[i * channels];
  }
}

// ----------------------------------------------------------- SPSC ring

// Lock-free single-producer single-consumer float ring. The size_ counter
// with acquire/release ordering is the producer/consumer sync point
// (contract identical to the reference ring, audio_ring_buffer.h:22-30).
struct SpscRing {
  float* buf = nullptr;
  int64_t capacity = 0;
  int64_t head = 0;  // consumer-owned
  int64_t tail = 0;  // producer-owned
  std::atomic<int64_t> size{0};
};

void* ring_create(int64_t capacity) {
  if (capacity <= 0) return nullptr;
  auto* r = new (std::nothrow) SpscRing();
  if (!r) return nullptr;
  r->buf = new (std::nothrow) float[capacity]();
  if (!r->buf) {
    delete r;
    return nullptr;
  }
  r->capacity = capacity;
  return r;
}

void ring_destroy(void* handle) {
  auto* r = static_cast<SpscRing*>(handle);
  if (!r) return;
  delete[] r->buf;
  delete r;
}

int64_t ring_capacity(void* handle) {
  return handle ? static_cast<SpscRing*>(handle)->capacity : 0;
}

int64_t ring_available_read(void* handle) {
  if (!handle) return 0;
  return static_cast<SpscRing*>(handle)->size.load(std::memory_order_acquire);
}

int64_t ring_available_write(void* handle) {
  if (!handle) return 0;
  auto* r = static_cast<SpscRing*>(handle);
  return r->capacity - r->size.load(std::memory_order_acquire);
}

// All-or-nothing append (producer thread). Returns 1 on success.
int ring_write(void* handle, const float* data, int64_t n) {
  auto* r = static_cast<SpscRing*>(handle);
  if (!r || n < 0) return 0;
  if (n > r->capacity - r->size.load(std::memory_order_acquire)) return 0;
  int64_t first = n < (r->capacity - r->tail) ? n : (r->capacity - r->tail);
  std::memcpy(r->buf + r->tail, data, first * sizeof(float));
  if (n > first) std::memcpy(r->buf, data + first, (n - first) * sizeof(float));
  r->tail = (r->tail + n) % r->capacity;
  r->size.fetch_add(n, std::memory_order_release);
  return 1;
}

// All-or-nothing pop (consumer thread). Returns 1 on success.
int ring_read(void* handle, float* out, int64_t n) {
  auto* r = static_cast<SpscRing*>(handle);
  if (!r || n < 0) return 0;
  if (n > r->size.load(std::memory_order_acquire)) return 0;
  int64_t first = n < (r->capacity - r->head) ? n : (r->capacity - r->head);
  std::memcpy(out, r->buf + r->head, first * sizeof(float));
  if (n > first) std::memcpy(out + first, r->buf, (n - first) * sizeof(float));
  r->head = (r->head + n) % r->capacity;
  r->size.fetch_sub(n, std::memory_order_release);
  return 1;
}

// Requires external synchronization (both threads quiescent) — same
// contract as the reference's clear().
void ring_clear(void* handle) {
  auto* r = static_cast<SpscRing*>(handle);
  if (!r) return;
  r->head = 0;
  r->tail = 0;
  r->size.store(0, std::memory_order_release);
}

int totton_native_abi_version() { return 1; }

}  // extern "C"
