// Amidar grey-frame kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel toybox_tpu/ops/render_pallas.py `_frame_call`
// (pl.pallas_call at :121) driving `_make_amidar_frame` (:357), fed by
// `_amidar_prep_frame` (:418), as reached from `make_amidar_gray_renderer`
// (:475, one frame) and `make_amidar_gray_maxpool_renderer` (:489, two
// frames fused by their element-wise max: the DeepMind skip-4 max-pool).
//
// Each env's prep (built in PyTorch by ops/render_amidar.py
// `amidar_prep`) is 1024 floats per frame, every value an integer held
// exactly in f32:
//   [0, 992)     tile codes, 31 rows x 32 columns: 0 background, 1 inside a
//                painted box, 2 painted, 3 unpainted (or chase marker);
//   [992, 1019)  9 sprites x (x, y, show) in pixels: the 8 enemies, then
//                the player; each a 4 x 5 rect;
//   [1019, 1024) padding.
// The lumas of the four tile codes, the enemies and the player come from
// the config and are passed by value. The kernel only compares, selects
// and truncates, so it is exact against the plain PyTorch version in
// ops/render_amidar.py.
//
// Design: the TPU kernel upsampled the tile codes on the MXU (a bf16
// one-hot column matmul) and drew the sprites as one outer-product matmul
// whose weights made the player win overlaps. Here each pixel is a
// select: a block takes one env and one band of 25 rows (10 bands, so
// even the 10-env serve fills 100 blocks), copies the env's prep (one or
// two frames, <= 8 KB) into shared memory, and its threads stride over
// the band's pixels. Each pixel takes the background, or on the board
// (5 x 4 px per tile at (16, 45)) its tile's luma, then any enemy, then
// the player (the player wins overlaps, drawn last as in the JAX render),
// and is clipped to [0, 255]. The fused form takes the max of two such
// values before the truncation (uint8)(int)v, which is exact since
// truncation is monotone.
//
// The `amidar_frame_warp` entry point composes the fused frame and warps
// it to 84 x 84 in the same launch (the `warp_to=84` form of
// `make_amidar_gray_maxpool_renderer`; the warp is in warp84.cuh). It
// takes a whole env per block, not a band: the warp needs every row.
//
// Bound on this card: bytes. At 1024 envs the fused kernel writes
// 1024 * 40000 B = 41.0 MB of frames and reads 1024 * 2 * 1024 * 4 B =
// 8.4 MB of prep: about 15 us at 3.35 TB/s. It does a few dozen compares
// per pixel, which may well make it bound by instruction throughput instead,
// as the Breakout kernel is.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp84.cuh"

namespace {

constexpr int kH = 250;
constexpr int kW = 160;
constexpr int kPrep = 1024;
constexpr int kBoardW = 32;
constexpr int kBoardY0 = 45;
constexpr int kBoardY1 = 45 + 31 * 5;
constexpr int kBoardX0 = 16;
constexpr int kBoardX1 = 16 + 32 * 4;
constexpr int kSprite0 = 992;
constexpr int kEnemies = 8;
constexpr int kBandRows = 25;
constexpr int kBands = kH / kBandRows;
constexpr int kThreads = 256;
constexpr int kConsts = 6;

static_assert(kBands * kBandRows == kH, "bands must tile the frame");

struct Consts {
  float tile[4];  // by tile code
  float enemy, player;
};

__device__ __forceinline__ bool covers(const float* s, float fx, float fy) {
  return fx >= s[0] && fx < s[0] + 4.0f && fy >= s[1] && fy < s[1] + 5.0f &&
         s[2] > 0.0f;
}

__device__ __forceinline__ float pixel_luma(const float* p, int y, int x,
                                            const Consts& c) {
  float v = c.tile[0];
  if (y >= kBoardY0 && y < kBoardY1 && x >= kBoardX0 && x < kBoardX1) {
    const int code = static_cast<int>(
        p[((y - kBoardY0) / 5) * kBoardW + (x - kBoardX0) / 4]);
    v = c.tile[min(max(code, 0), 3)];
  }
  const float fx = static_cast<float>(x);
  const float fy = static_cast<float>(y);
  for (int k = 0; k < kEnemies; ++k) {
    if (covers(p + kSprite0 + 3 * k, fx, fy)) v = c.enemy;
  }
  if (covers(p + kSprite0 + 3 * kEnemies, fx, fy)) v = c.player;
  return fminf(fmaxf(v, 0.0f), 255.0f);
}

__global__ void __launch_bounds__(kThreads)
amidar_frame_kernel(const float* __restrict__ prep,
                    uint8_t* __restrict__ out, int fused, Consts c) {
  __shared__ float sp[2 * kPrep];
  const int frames = fused ? 2 : 1;
  const float* src = prep + static_cast<size_t>(blockIdx.x) * frames * kPrep;
  for (int i = threadIdx.x; i < frames * kPrep; i += blockDim.x) {
    sp[i] = src[i];
  }
  __syncthreads();

  const int y0 = blockIdx.y * kBandRows;
  uint8_t* dst = out + (static_cast<size_t>(blockIdx.x) * kH + y0) * kW;
  for (int i = threadIdx.x; i < kBandRows * kW; i += blockDim.x) {
    const int y = y0 + i / kW;
    const int x = i % kW;
    float v = pixel_luma(sp, y, x, c);
    if (fused) v = fmaxf(v, pixel_luma(sp + kPrep, y, x, c));
    dst[i] = static_cast<uint8_t>(static_cast<int>(v));
  }
}

__global__ void __launch_bounds__(warp84::kThreads)
amidar_frame_warp_kernel(const float* __restrict__ prep,
                         uint8_t* __restrict__ out, Consts c,
                         warp84::Args a) {
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
        return fmaxf(pixel_luma(p0, y, x, c), pixel_luma(p1, y, x, c));
      },
      a, out + static_cast<size_t>(blockIdx.x) * a.size * a.size);
}

// The host constants (see amidar_frame below) -> Consts; false if
// malformed.
bool parse_consts(const float* consts, int n_consts, Consts* c) {
  if (n_consts != kConsts) return false;
  for (int k = 0; k < 4; ++k) c->tile[k] = consts[k];
  c->enemy = consts[4];
  c->player = consts[5];
  return true;
}

}  // namespace

// prep: f32[n, fused ? 2 : 1, 1024]; out: u8[n, 250, 160]; both on
// `device`. consts (host): the lumas of tile codes 0..3 (background,
// inside a painted box, painted, unpainted), of the enemies and of the
// player. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int amidar_frame(const float* prep, uint8_t* out, int n,
                            int fused, const float* consts, int n_consts,
                            int device, void* stream) {
  Consts c;
  if (!parse_consts(consts, n_consts, &c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    amidar_frame_kernel<<<dim3(n, kBands), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(prep, out,
                                                               fused, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fused frame warped in the same launch. prep: f32[n, 2, 1024]; out:
// u8[n, size, size]; wy f32[size, 250], wx f32[size, 160] and taps
// i32[2, size, 2] (see warp84.cuh), all on `device`. consts as above.
// Launches on `stream` and returns the first CUDA error (0 on success).
extern "C" int amidar_frame_warp(const float* prep, uint8_t* out, int n,
                                 const float* consts, int n_consts,
                                 const float* wy, const float* wx,
                                 const int* taps, int size, int device,
                                 void* stream) {
  Consts c;
  if (!parse_consts(consts, n_consts, &c) || size <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = warp84::smem_bytes(kH, kW, size);
  err = warp84::allow_smem(
      reinterpret_cast<const void*>(amidar_frame_warp_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    amidar_frame_warp_kernel<<<n, warp84::kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        prep, out, c, warp84::Args{wy, wx, taps, size});
  }
  return static_cast<int>(cudaGetLastError());
}
