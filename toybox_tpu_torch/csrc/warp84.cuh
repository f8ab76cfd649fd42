// The in-kernel warp of the fused frame kernels for Hopper (sm_90a),
// shared by csrc/breakout_frame.cu, csrc/si_frame.cu and
// csrc/amidar_frame.cu (their `<name>_warp` entry points).
//
// Replaces the `warp_to` branch of the TPU kernel body in
// toybox_tpu/ops/render_pallas.py `_frame_call` (:80-112), as reached from
// `make_breakout_gray_maxpool_renderer` (:324),
// `make_amidar_gray_maxpool_renderer` (:489) and
// `make_si_gray_maxpool_renderer` (:722) with warp_to=84: the max of two
// composed frames, truncated to an integer, warped to size x size as
// Wy.img.Wx^T in f32, rounded half to even and clipped to [0, 255].
//
// Design: one block per env. The block composes its env's max-pooled,
// truncated frame into shared memory as u8 (the game's own per-pixel
// luma), then takes the contraction in the order of the JAX `oh,hw,pw`
// einsum: t[i, x] = sum_y Wy[i, y] img[y, x] into shared f32, then
// out[i, j] = sum_x t[i, x] Wx[j, x]. Each output row of Wy and Wx has
// only a few nonzero taps (3-8 at 84 from 160-320), so each sum runs over
// its band only, in increasing index order, one rounded f32 multiply and
// one rounded add per tap (__fmul_rn, __fadd_rn: never contracted into an
// FMA). Every term is >= 0 and the terms outside the band are +0, so the
// band's sum equals the full ordered sum bit for bit, and the kernel is
// exact against its plain PyTorch version (ops/obs.py `banded_warp`).
//
// Shared memory per block, above the 48 KB static limit, so dynamic:
// size * W * 4 B of t plus H * W B of frame (Breakout 80 640 + 38 400 B,
// Space Invaders 107 520 + 67 200 B, Amidar 53 760 + 40 000 B at 84).
//
// Bound on this card: operations, barely (at 1024 envs the composition's
// selects and the bands' 0.2-0.4 M multiplies and adds per env take about
// 5-9 us at 67 TFLOP/s; the prep read and the 7 056 B per env written take
// 3-5 us at 3.35 TB/s). In practice the composition costs what the fused
// kernel costs (instruction throughput), and the large shared footprint
// leaves one or two blocks per SM; this first version is simple and exact,
// not tuned.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace warp84 {

constexpr int kThreads = 512;

struct Args {
  const float* wy;  // f32[size, H]
  const float* wx;  // f32[size, W]
  const int* taps;  // i32[2, size, 2]: (first, count) of each Wy row, then
                    // of each Wx row
  int size;
};

// Dynamic shared memory of one block: t f32[size, W], then the frame
// u8[H, W].
inline size_t smem_bytes(int h, int w, int size) {
  return static_cast<size_t>(size) * w * sizeof(float) +
         static_cast<size_t>(h) * w;
}

// luma(y, x): the max-pooled f32 luma of pixel (y, x), in [0, 255].
// Writes u8[size, size] to dst. Call from every thread of the block.
template <int H, int W, class Luma>
__device__ __forceinline__ void compose_and_warp(Luma luma, const Args& a,
                                                 uint8_t* __restrict__ dst) {
  extern __shared__ float4 smem4[];
  float* t = reinterpret_cast<float*>(smem4);
  uint8_t* img = reinterpret_cast<uint8_t*>(t + a.size * W);

  for (int i = threadIdx.x; i < H * W; i += blockDim.x) {
    const int y = i / W;
    const int x = i - y * W;
    img[i] = static_cast<uint8_t>(static_cast<int>(luma(y, x)));
  }
  __syncthreads();

  // rows: t[i, x] = sum over row i's band of Wy[i, y] * img[y, x]
  for (int k = threadIdx.x; k < a.size * W; k += blockDim.x) {
    const int i = k / W;
    const int x = k - i * W;
    const int first = __ldg(a.taps + 2 * i);
    const int count = __ldg(a.taps + 2 * i + 1);
    const float* w = a.wy + static_cast<size_t>(i) * H + first;
    const uint8_t* v = img + first * W + x;
    float acc = 0.0f;
    for (int m = 0; m < count; ++m) {
      acc = __fadd_rn(acc, __fmul_rn(__ldg(w + m),
                                     static_cast<float>(v[m * W])));
    }
    t[k] = acc;
  }
  __syncthreads();

  // columns: out[i, j] = sum over column j's band of Wx[j, x] * t[i, x]
  const int* xtaps = a.taps + 2 * a.size;
  for (int k = threadIdx.x; k < a.size * a.size; k += blockDim.x) {
    const int i = k / a.size;
    const int j = k - i * a.size;
    const int first = __ldg(xtaps + 2 * j);
    const int count = __ldg(xtaps + 2 * j + 1);
    const float* w = a.wx + static_cast<size_t>(j) * W + first;
    const float* v = t + i * W + first;
    float acc = 0.0f;
    for (int m = 0; m < count; ++m) {
      acc = __fadd_rn(acc, __fmul_rn(__ldg(w + m), v[m]));
    }
    const float r = fminf(fmaxf(rintf(acc), 0.0f), 255.0f);
    dst[k] = static_cast<uint8_t>(static_cast<int>(r));
  }
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB).
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace warp84
