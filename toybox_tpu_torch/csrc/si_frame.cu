// Space Invaders grey-frame kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel toybox_tpu/ops/render_pallas.py `_frame_call`
// (pl.pallas_call at :121) driving `_make_si_frame` (:517), fed by
// `_si_prep_frame` (:621), as reached from `make_si_gray_renderer` (:710,
// one frame) and `make_si_gray_maxpool_renderer` (:722, two frames fused
// by their element-wise max: the DeepMind skip-4 max-pool).
//
// Each env's prep (built in PyTorch by ops/render_si.py `si_prep`) is 128
// floats per frame, every value an integer held exactly in f32:
//   [0, 54)    shield rows: entry 18 * s + r is row r of shield s as a
//              16-bit mask (bit x = column x);
//   [54, 90)   formation show grid, 6 x 6, row-major (1 shown, 0 not);
//   [90, 92)   formation anchor (enemy 0's x, y);
//   [92, 113)  7 sprites x (x, y, show): the UFO (16 x 10), the ship
//              (16 x 10), the ship laser and 4 enemy lasers (2 x 8 each);
//   [113, 128) padding.
// The constants (lumas, shield placement) come from the config and are
// passed by value. The kernel only compares, selects and truncates, so it
// is exact against the plain PyTorch version in ops/render_si.py.
//
// Design: the TPU kernel composed the frame on the MXU, as one bf16
// outer-product matmul whose power-of-two weights encode the draw order.
// Here each pixel is a select: a block takes one env and one band of 15
// rows (14 bands, so even the 10-env serve fills 140 blocks), copies the
// env's prep (one or two frames, <= 1 KB) into shared memory, and its
// threads stride over the band's pixels. Each pixel takes, in draw order,
// the background, a formation cell, a shield pixel (the last shield that
// covers it decides, as the JAX render pastes them), the UFO, the ship,
// then any laser, and is clipped to [0, 255]. The fused form takes the
// max of two such values before the truncation (uint8)(int)v, which is
// exact since truncation is monotone.
//
// The `si_frame_warp` entry point composes the fused frame and warps it to
// 84 x 84 in the same launch (the `warp_to=84` form of
// `make_si_gray_maxpool_renderer`; the warp is in warp84.cuh). It takes a
// whole env per block, not a band: the warp needs every row.
//
// Bound on this card: bytes. At 1024 envs the fused kernel writes
// 1024 * 67200 B = 68.8 MB of frames and reads 1024 * 2 * 128 * 4 B =
// 1.0 MB of prep: about 21 us at 3.35 TB/s. It does a few dozen integer
// compares per pixel, which may well make it bound by instruction throughput
// instead, as the Breakout kernel is.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp84.cuh"

namespace {

constexpr int kH = 210;
constexpr int kW = 320;
constexpr int kPrep = 128;
constexpr int kShieldRows = 0;
constexpr int kShow = 54;
constexpr int kAnchor = 90;
constexpr int kSprite0 = 92;
constexpr int kSprites = 7;
constexpr int kMaxShields = 3;
constexpr int kBandRows = 15;
constexpr int kBands = kH / kBandRows;
constexpr int kThreads = 256;
constexpr int kConsts = 11;

static_assert(kBands * kBandRows == kH, "bands must tile the frame");

struct Consts {
  float bg, enemy, shield, ufo, ship, laser;
  int n_shields, shield_y;
  int shield_x[kMaxShields];
};

__device__ __forceinline__ bool covers(const float* s, float w, float h,
                                       float fx, float fy) {
  return fx >= s[0] && fx < s[0] + w && fy >= s[1] && fy < s[1] + h &&
         s[2] > 0.0f;
}

__device__ __forceinline__ float pixel_luma(const float* p, int y, int x,
                                            const Consts& c) {
  float v = c.bg;
  const int rx = x - static_cast<int>(p[kAnchor]);
  const int ry = y - static_cast<int>(p[kAnchor + 1]);
  if (rx >= 0 && ry >= 0 && rx < 6 * 32 && ry < 6 * 18 && rx % 32 < 16 &&
      ry % 18 < 10 && p[kShow + (ry / 18) * 6 + rx / 32] > 0.0f) {
    v = c.enemy;
  }
  bool shield = false;
  const int sy = y - c.shield_y;
  for (int s = 0; s < c.n_shields; ++s) {
    const int sx = x - c.shield_x[s];
    if (sx >= 0 && sx < 16 && sy >= 0 && sy < 18) {
      shield = (static_cast<int>(p[kShieldRows + 18 * s + sy]) >> sx) & 1;
    }
  }
  if (shield) v = c.shield;
  const float fx = static_cast<float>(x);
  const float fy = static_cast<float>(y);
  if (covers(p + kSprite0, 16.0f, 10.0f, fx, fy)) v = c.ufo;
  if (covers(p + kSprite0 + 3, 16.0f, 10.0f, fx, fy)) v = c.ship;
  for (int k = 2; k < kSprites; ++k) {
    if (covers(p + kSprite0 + 3 * k, 2.0f, 8.0f, fx, fy)) v = c.laser;
  }
  return fminf(fmaxf(v, 0.0f), 255.0f);
}

__global__ void __launch_bounds__(kThreads)
si_frame_kernel(const float* __restrict__ prep, uint8_t* __restrict__ out,
                int fused, Consts c) {
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
si_frame_warp_kernel(const float* __restrict__ prep,
                     uint8_t* __restrict__ out, Consts c, warp84::Args a) {
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

// The host constants (see si_frame below) -> Consts; false if malformed.
bool parse_consts(const float* consts, int n_consts, Consts* c) {
  if (n_consts != kConsts) return false;
  c->bg = consts[0];
  c->enemy = consts[1];
  c->shield = consts[2];
  c->ufo = consts[3];
  c->ship = consts[4];
  c->laser = consts[5];
  c->n_shields = static_cast<int>(consts[6]);
  c->shield_y = static_cast<int>(consts[7]);
  if (c->n_shields < 0 || c->n_shields > kMaxShields) return false;
  for (int s = 0; s < kMaxShields; ++s) {
    c->shield_x[s] = static_cast<int>(consts[8 + s]);
  }
  return true;
}

}  // namespace

// prep: f32[n, fused ? 2 : 1, 128]; out: u8[n, 210, 320]; both on `device`.
// consts (host): the background, enemy, shield, UFO, ship and laser lumas,
// then the shield count (<= 3), the shields' row y and up to 3 shield xs.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int si_frame(const float* prep, uint8_t* out, int n, int fused,
                        const float* consts, int n_consts, int device,
                        void* stream) {
  Consts c;
  if (!parse_consts(consts, n_consts, &c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    si_frame_kernel<<<dim3(n, kBands), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(prep, out, fused,
                                                           c);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fused frame warped in the same launch. prep: f32[n, 2, 128]; out:
// u8[n, size, size]; wy f32[size, 210], wx f32[size, 320] and taps
// i32[2, size, 2] (see warp84.cuh), all on `device`. consts as above.
// Launches on `stream` and returns the first CUDA error (0 on success).
extern "C" int si_frame_warp(const float* prep, uint8_t* out, int n,
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
  err = warp84::allow_smem(reinterpret_cast<const void*>(si_frame_warp_kernel),
                           smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    si_frame_warp_kernel<<<n, warp84::kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        prep, out, c, warp84::Args{wy, wx, taps, size});
  }
  return static_cast<int>(cudaGetLastError());
}
