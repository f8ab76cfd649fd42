// Breakout grey-frame kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel toybox_tpu/ops/render_pallas.py `_frame_call`
// (pl.pallas_call at :121) driving `_make_breakout_frame` (:173), as
// reached from `make_breakout_gray_renderer` (:307, one frame) and
// `make_breakout_gray_maxpool_renderer` (:324, two frames fused by their
// element-wise max: the DeepMind skip-4 max-pool).
//
// Each env's prep (built in PyTorch by ops/render_cuda.py `breakout_prep`)
// is PREP floats per frame:
//   [0, 432)    brick luma grid, 24 rows x 18 cols, -1 where no brick;
//   [432, 457)  5 sprites x (x_lo, x_hi, y_lo, y_hi, show): sprite 0 is
//               the paddle, sprites 1..4 the balls;
//   [457, 464)  padding.
// The brick luma formula stays in the prep, as in the JAX package, so the
// kernel only compares, selects and truncates: it is exact against the
// plain PyTorch version in ops/render_cuda.py (`frame_plain`).
//
// Design: one block per env, threads striding over the 160 x 240 pixels.
// The block first copies its env's prep (one or two frames, <= 3.7 KB)
// into shared memory. Each pixel then takes, in order: the static base
// (background, walls), the brick cell if its grid value is >= 0, the
// paddle, then any ball (balls win overlaps); it is clipped to [0, 255].
// The fused form takes the max of two such values before the truncation
// (uint8)(int)v, which is exact since truncation is monotone.
//
// The `breakout_frame_warp` entry point composes the fused frame and warps
// it to 84 x 84 in the same launch (the `warp_to=84` form of
// `make_breakout_gray_maxpool_renderer`; the warp is in warp84.cuh).
//
// Bound on this card: bytes. At 1024 envs the fused kernel writes
// 1024 * 38400 B = 39.3 MB of frames and reads 1024 * 2 * 464 * 4 B =
// 3.8 MB of prep: about 13 us at 3.35 TB/s. It does a handful of compares
// per pixel, far below the compute roof.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp84.cuh"

namespace {

constexpr int kH = 160;
constexpr int kW = 240;
constexpr int kPrep = 464;
constexpr int kGridCols = 18;
constexpr int kBandY0 = 43;
constexpr int kBandY1 = 43 + 24 * 4;
constexpr int kBandX0 = 12;
constexpr int kBandX1 = 12 + kGridCols * 12;
constexpr int kSprite0 = 432;
constexpr int kSprites = 5;
constexpr int kThreads = 256;

__device__ __forceinline__ bool covers(const float* s, float fx, float fy) {
  return fx >= s[0] && fx < s[1] && fy >= s[2] && fy < s[3] && s[4] > 0.0f;
}

__device__ __forceinline__ float pixel_luma(const float* p, int y, int x,
                                            float bg, float wall, float pad,
                                            float ball) {
  const float fx = static_cast<float>(x);
  const float fy = static_cast<float>(y);
  float v = (y >= 15 && (x < 12 || x >= 228 || y < 18)) ? wall : bg;
  if (y >= kBandY0 && y < kBandY1 && x >= kBandX0 && x < kBandX1) {
    const float c = p[((y - kBandY0) >> 2) * kGridCols + (x - kBandX0) / 12];
    if (c >= 0.0f) v = c;
  }
  if (covers(p + kSprite0, fx, fy)) v = pad;
  for (int k = 1; k < kSprites; ++k) {
    if (covers(p + kSprite0 + 5 * k, fx, fy)) v = ball;
  }
  return fminf(fmaxf(v, 0.0f), 255.0f);
}

__global__ void __launch_bounds__(kThreads)
breakout_frame_kernel(const float* __restrict__ prep,
                      uint8_t* __restrict__ out, int fused, float bg,
                      float wall, float pad, float ball) {
  __shared__ float sp[2 * kPrep];
  const int frames = fused ? 2 : 1;
  const float* src = prep + static_cast<size_t>(blockIdx.x) * frames * kPrep;
  for (int i = threadIdx.x; i < frames * kPrep; i += blockDim.x) {
    sp[i] = src[i];
  }
  __syncthreads();

  uint8_t* dst = out + static_cast<size_t>(blockIdx.x) * kH * kW;
  for (int i = threadIdx.x; i < kH * kW; i += blockDim.x) {
    const int y = i / kW;
    const int x = i - y * kW;
    float v = pixel_luma(sp, y, x, bg, wall, pad, ball);
    if (fused) v = fmaxf(v, pixel_luma(sp + kPrep, y, x, bg, wall, pad, ball));
    dst[i] = static_cast<uint8_t>(static_cast<int>(v));
  }
}

__global__ void __launch_bounds__(warp84::kThreads)
breakout_frame_warp_kernel(const float* __restrict__ prep,
                           uint8_t* __restrict__ out, float bg, float wall,
                           float pad, float ball, warp84::Args a) {
  __shared__ float sp[2 * kPrep];
  const float* src = prep + static_cast<size_t>(blockIdx.x) * 2 * kPrep;
  for (int i = threadIdx.x; i < 2 * kPrep; i += blockDim.x) {
    sp[i] = src[i];
  }
  __syncthreads();
  const float* p0 = sp;
  const float* p1 = sp + kPrep;
  warp84::compose_and_warp<kH, kW>(
      [=](int y, int x) {
        return fmaxf(pixel_luma(p0, y, x, bg, wall, pad, ball),
                     pixel_luma(p1, y, x, bg, wall, pad, ball));
      },
      a, out + static_cast<size_t>(blockIdx.x) * a.size * a.size);
}

}  // namespace

// prep: f32[n, fused ? 2 : 1, 464]; out: u8[n, 160, 240]; both on `device`.
// consts (host): the background, wall, paddle and ball lumas.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int breakout_frame(const float* prep, uint8_t* out, int n,
                              int fused, const float* consts, int n_consts,
                              int device, void* stream) {
  if (n_consts != 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    breakout_frame_kernel<<<n, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        prep, out, fused, consts[0], consts[1], consts[2], consts[3]);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fused frame warped in the same launch. prep: f32[n, 2, 464]; out:
// u8[n, size, size]; wy f32[size, 160], wx f32[size, 240] and taps
// i32[2, size, 2] (see warp84.cuh), all on `device`. consts as above.
// Launches on `stream` and returns the first CUDA error (0 on success).
extern "C" int breakout_frame_warp(const float* prep, uint8_t* out, int n,
                                   const float* consts, int n_consts,
                                   const float* wy, const float* wx,
                                   const int* taps, int size, int device,
                                   void* stream) {
  if (n_consts != 4 || size <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = warp84::smem_bytes(kH, kW, size);
  err = warp84::allow_smem(
      reinterpret_cast<const void*>(breakout_frame_warp_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    breakout_frame_warp_kernel<<<n, warp84::kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        prep, out, consts[0], consts[1], consts[2], consts[3],
        warp84::Args{wy, wx, taps, size});
  }
  return static_cast<int>(cudaGetLastError());
}
