// The 16-pixel chunk composition shared by the frame kernels of
// csrc/si_frame.cu, csrc/amidar_frame.cu and csrc/breakout_frame.cu (their
// frame entry points, and Breakout's warp entry point).
//
// A thread composes 16 consecutive pixels of a row as four u32 words of
// four u8 pixels each, and writes them with one 16-byte store. Each layer
// of the frame (a sprite, a run of formation cells, a shield row) becomes
// a 16-bit mask of the chunk, bit j for pixel j, from integer interval
// tests, and is painted over the words by a bit select against its luma
// byte replicated four times. The spans come from the f32 prep through
// `span`, which keeps exactly the pixels of the plain versions' f32
// compares (ops/render_si.py, ops/render_amidar.py).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace chunk16 {

constexpr int kChunk = 16;  // pixels a thread composes
constexpr int kSMs = 132;   // H100 SXM

// The integer pixels [lo, hi) that the f32 test lo_f <= x < lo_f + size
// covers for integer x, clipped to [0, limit]: x >= lo_f iff
// x >= ceil(lo_f), and x < v iff x < ceil(v), clipped in f32 before the
// conversion so that no value overflows.
__device__ __forceinline__ int2 span(float lo_f, float size, int limit) {
  const float hi_f = lo_f + size;
  return make_int2(
      static_cast<int>(fminf(fmaxf(ceilf(lo_f), 0.0f), limit)),
      static_cast<int>(fminf(fmaxf(ceilf(hi_f), 0.0f), limit)));
}

// The two-edge form: the integer pixels [lo, hi) that the f32 test
// lo_f <= x < hi_f covers for integer x, clipped to [0, limit] as above.
// A NaN edge covers nothing, as the f32 compares do.
__device__ __forceinline__ int2 span2(float lo_f, float hi_f, int limit) {
  if (lo_f != lo_f || hi_f != hi_f) return make_int2(0, 0);
  return make_int2(
      static_cast<int>(fminf(fmaxf(ceilf(lo_f), 0.0f), limit)),
      static_cast<int>(fminf(fmaxf(ceilf(hi_f), 0.0f), limit)));
}

// v (< 2^23) as f32, exactly, without an integer-to-float conversion:
// the bits 0x4B000000 | v are the float 2^23 + v.
__device__ __forceinline__ float exact_float(uint32_t v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.0f);
}

// Bits of the pixels [a, b) in the chunk that starts at x0.
__device__ __forceinline__ uint32_t chunk_mask(int a, int b, int x0) {
  const int lo = min(max(a - x0, 0), kChunk);
  const int hi = min(max(b - x0, 0), kChunk);
  return ((1u << hi) - 1u) & ~((1u << lo) - 1u);
}

// Paint the pixels of mask m (bit j = pixel j of the chunk) with the byte
// replicated in `word`: word k of w holds pixels 4k..4k+3.
__device__ __forceinline__ void paint(uint32_t w[4], uint32_t m,
                                      uint32_t word) {
  if (m == 0) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t nib = (m >> (4 * k)) & 0xFu;
    // nibble bit j -> byte j (no carries: the terms' bits never meet)
    const uint32_t bytes = ((nib * 0x00204081u) & 0x01010101u) * 0xFFu;
    w[k] = (w[k] & ~bytes) | (word & bytes);
  }
}

// Row bands per env of an h-row frame for n envs: the fewest that divide
// h and give each SM four blocks (whole frames once n >= 4 * kSMs), and at
// most max_bands (which must divide h) for the small batches of a serve.
inline int bands_for(int n, int h, int max_bands) {
  int bands = 1;
  while (bands < max_bands &&
         (static_cast<long>(n) * bands < 4 * kSMs || h % bands != 0)) {
    ++bands;
  }
  return bands;
}

}  // namespace chunk16
