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
// Design: a first version here composed every pixel in f32 (a division by
// the width and one by the cell width, the wall and band tests, five
// sprites' four compares each, twice for the fused form, a one-byte
// store), bound by instruction issue at 17x its byte bound (0.219 ms fused
// at 1024 envs). Every boundary of Breakout's static frame lies on a
// multiple of 4 pixels (walls at x < 12 and x >= 228 from y = 15, the top
// wall at 15 <= y < 18, the brick band at 12 <= x < 228 in 12-pixel
// cells from y = 43), so the static layers of a 4-pixel word are one byte
// replicated four times. This kernel does the work once where it is the
// same, in integers (as csrc/si_frame.cu and csrc/amidar_frame.cu do):
//   - per block (one env, a band of rows): the prep into shared memory
//     (float4 loads, all in flight at once), a barrier, then one pass
//     over it: each brick cell of the cell rows the band meets becomes
//     its luma's byte (clipped to [0, 255] and truncated; a grid value
//     < 0 is no brick, so the background) written over the cell's three
//     words of a 60-word row table that also holds the side walls; each
//     sprite's x span [x0, x1), the ceil of its two f32 edges clipped to
//     the frame (chunk16::span2), empty when show <= 0; and for each row
//     which sprites of each frame cross it (the plain version's f32
//     test). Then a second barrier;
//   - per 16-pixel chunk of a row (15 a row): the four static words, one
//     16-byte shared load in the brick band, else the background or the
//     wall word; then, only if a sprite crosses the row, the paddle and
//     then the balls (balls win overlaps) as 16-bit masks of the chunk,
//     painted by a bit select against their bytes replicated four times.
// Each chunk is written with one 16-byte store; a band's rows are
// contiguous, so chunk i of a band is at byte 16 i (row pitch 240 B, frame
// 38 400 B: both multiples of 16). The lumas become their final bytes on
// the host, (uint8)(int)clamp(luma, 0, 255), and the brick lumas in the
// set-up the same way. Clip, truncation and max are monotone and the
// kernel only selects, so the fused form's byte max (__vmaxu4, taken only
// where the two frames' words differ) equals the plain version's
// truncated max of the f32 lumas, bit for bit.
// Grid: blocks of 256 threads, (n, bands): chunk16::bands_for takes whole
// frames (one band) when n envs give the 132 SMs four blocks each
// (n >= 528), and up to 16 bands of 10 rows below that. The serve (n = 10)
// gets 160 blocks; n = 1024 gets 1024 blocks of 9.4 chunks a thread.
//
// The `breakout_frame_warp` entry point composes the fused frame and warps
// it to 84 x 84 in the same launch (the `warp_to=84` form of
// `make_breakout_gray_maxpool_renderer`; the warp stage is in warp84.cuh).
// Its blocks take one env each (4 warps) and build the same tables for the
// whole frame, the prep held in the warp stages until they start; the
// stage composes the frame by the same 16-pixel chunks (`frame_chunk`)
// and never holds it.
//
// Bound on this card: bytes. At 1024 envs the fused kernel writes
// 1024 * 38400 B = 39.3 MB of frames and reads 1024 * 2 * 464 * 4 B =
// 3.8 MB of prep: 12.9 us at 3.35 TB/s (12.3 us for one frame). The warp
// form writes 7 MB and reads the same prep: its ordered multiplies and
// adds bound it (5.3 us, warp84.cuh). Measured on an NVIDIA H100 80GB
// HBM3 at 700 W (chip_smoke.py phase 3, kernel time from torch.profiler,
// 1024 envs): 18.4 us fused (70 % of the bound), 15.8 us single (78 %),
// 2.7 us fused at 10 envs; the warp form 51.8 us. With only the
// background stored (scripts/frame_kernel_variants.py) the frame kernel
// takes 15.5 us fused: the stores at 2.5 TB/s after the set-up; the two
// compositions add 3 us. ptxas (sm_90a): the frame kernel 40 registers,
// no spills, 15 968 B of shared memory, 8 blocks (64 warps) an SM; the
// warp kernel 64 registers (its launch bound), 16 B spilled, 27 568 B, 8
// blocks (32 warps) an SM, so that 1024 envs take one wave.

#include <cstdint>
#include <cuda_runtime.h>

#include "chunk16.cuh"
#include "warp84.cuh"

namespace {

using chunk16::chunk_mask;
using chunk16::exact_float;
using chunk16::kChunk;
using chunk16::paint;
using chunk16::span2;

constexpr int kH = 160;
constexpr int kW = 240;
constexpr int kPrep = 464;
constexpr int kGridRows = 24;
constexpr int kGridCols = 18;
constexpr int kCellW = 12;
constexpr int kCellH = 4;
constexpr int kBandY0 = 43;
constexpr int kBandY1 = kBandY0 + kGridRows * kCellH;   // 139
constexpr int kBandX0 = 12;
constexpr int kBandX1 = kBandX0 + kGridCols * kCellW;   // 228
constexpr int kWallY0 = 15;                             // walls from here
constexpr int kWallY1 = 18;                             // the top wall's end
constexpr int kSprite0 = 432;
constexpr int kSprites = 5;                             // paddle, 4 balls
constexpr int kWords = kW / 4;                          // 60
constexpr int kWallL = kBandX0 / 4;                     // words 0..2
constexpr int kWallR = kBandX1 / 4;                     // words 57..59
constexpr int kCellWords = kCellW / 4;                  // 3
constexpr int kRowChunks = kW / kChunk;                 // 15
constexpr int kThreads = 256;
constexpr int kMaxBands = 16;                           // bands of >= 10 rows
constexpr int kWarpKY = 4;                              // Wy taps (160 -> 84)
constexpr int kWarpKX = 6;                              // Wx taps (240 -> 84)
constexpr int kWarpRows = 8;                            // rows composed ahead

static_assert(kRowChunks * kChunk == kW, "chunks must tile a row");
static_assert(kH % kMaxBands == 0, "the most bands must tile the frame");
static_assert(kW % 16 == 0 && (kH * kW) % 16 == 0, "16-byte stores");
static_assert(kBandX0 % 4 == 0 && kBandX1 % 4 == 0 && kCellW % 4 == 0,
              "the walls and the brick cells must lie on whole words");
static_assert(kGridCols * kCellWords + 2 * kWallL == kWords,
              "walls and cells must fill a row");
static_assert(kPrep % 4 == 0, "float4 prep loads");

struct Consts {           // each luma's byte, replicated four times
  uint32_t bg, wall, pad, ball;
};

struct Frame {            // one frame's block-wide tables, in shared memory
  alignas(16) uint32_t cells[kGridRows][kWords];  // the static words of the
                          // brick band's rows (walls, bricks, background):
                          // only the cell rows the block's rows meet
  int2 xspan[kSprites];
};

struct Tables {
  Frame fr[2];
  uint32_t row[kH];       // sprites crossing row y0 + r: bits [0, 5) of
                          // frame 0, bits [8, 13) of frame 1
};

// 4 warps a block, each composing 8 rows ahead
using WarpShared = warp84::Shared<kH, kW, kWarpKY, 4, kWarpRows>;
static_assert(sizeof(WarpShared::rows) >= 2 * kPrep * 4,
              "the warp stages hold the prep during the set-up");

// The kernels' shared memory, at namespace scope so that the warp stage's
// composition callback reads it without a capture.
__shared__ Tables tables;
__shared__ WarpShared ws;

// The static word (walls or background) of word wi of row y outside the
// brick band.
__device__ __forceinline__ uint32_t base_word(int y, int wi,
                                              const Consts& c) {
  const bool wall =
      y >= kWallY0 && (y < kWallY1 || wi < kWallL || wi >= kWallR);
  return wall ? c.wall : c.bg;
}

__device__ __forceinline__ bool in_band(int y) {
  return y >= kBandY0 && y < kBandY1;
}

// The prep of `frames` frames at src into shared memory at dst, one
// float4 a thread at a time, every load in flight at once.
__device__ __forceinline__ void load_prep(const float* __restrict__ src,
                                          int frames, float4* dst,
                                          int nthreads) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < frames * kPrep / 4; i += nthreads) {
    dst[i] = __ldg(s4 + i);
  }
}

// One pass over the prep of `frames` frames in shared memory at src for
// rows [y0, y0 + rows), by the block's nthreads threads: the brick band's
// row words, the sprites' x spans and each row's sprite bits (see the
// note above).
__device__ __forceinline__ void build_tables(const float* src, int frames,
                                             int y0, int rows,
                                             const Consts& c, Tables& tb,
                                             int nthreads) {
  // the cell rows [cr0, cr1) that rows [y0, y0 + rows) meet
  const int lo = max(y0, kBandY0);
  const int hi = min(y0 + rows, kBandY1);
  const int cr0 = (lo - kBandY0) / kCellH;
  const int cell_items = hi > lo
      ? ((hi - 1 - kBandY0) / kCellH + 1 - cr0) * (kGridCols + 1) : 0;
  const int per_frame = cell_items + kSprites;
  const int items = frames * per_frame + rows;
  for (int i = threadIdx.x; i < items; i += nthreads) {
    if (i < frames * per_frame) {
      const int f = i / per_frame;
      const int j = i - f * per_frame;
      const float* p = src + f * kPrep;
      Frame& fr = tb.fr[f];
      if (j < cell_items) {
        const int q = j / (kGridCols + 1);
        const int col = j - q * (kGridCols + 1);
        const int cr = cr0 + q;
        uint32_t* w = fr.cells[cr];
        if (col < kGridCols) {
          const float g = p[cr * kGridCols + col];
          const uint32_t word = g >= 0.0f
              ? static_cast<uint32_t>(static_cast<int>(fminf(g, 255.0f))) *
                    0x01010101u
              : c.bg;
#pragma unroll
          for (int k = 0; k < kCellWords; ++k) {
            w[kWallL + kCellWords * col + k] = word;
          }
        } else {
#pragma unroll
          for (int k = 0; k < kWallL; ++k) {
            w[k] = c.wall;
            w[kWallR + k] = c.wall;
          }
        }
      } else {
        const int k = j - cell_items;
        const float* s = p + kSprite0 + 5 * k;
        fr.xspan[k] = s[4] > 0.0f ? span2(s[0], s[1], kW)
                                  : make_int2(0, 0);
      }
    } else {
      const int r = i - frames * per_frame;
      const float fy = exact_float(static_cast<uint32_t>(y0 + r));
      uint32_t bits = 0;
      for (int f = 0; f < frames; ++f) {
#pragma unroll
        for (int k = 0; k < kSprites; ++k) {
          const float* s = src + f * kPrep + kSprite0 + 5 * k;
          bits |= static_cast<uint32_t>(fy >= s[2] && fy < s[3] &&
                                        s[4] > 0.0f) << (8 * f + k);
        }
      }
      tb.row[r] = bits;
    }
  }
}

// The paddle's (x) and the balls' (y) pixels among the 16 from x0, for the
// sprites of `bits` (bit k: sprite k crosses the row).
__device__ __forceinline__ uint2 sprite_masks(const Frame& fr, uint32_t bits,
                                              int x0) {
  uint32_t pad = 0, ball = 0;
  if (bits & 1u) pad = chunk_mask(fr.xspan[0].x, fr.xspan[0].y, x0);
  for (uint32_t b = bits >> 1; b; b &= b - 1) {
    const int k = __ffs(b);               // sprite k: ball k - 1
    ball |= chunk_mask(fr.xspan[k].x, fr.xspan[k].y, x0);
  }
  return make_uint2(pad, ball);
}

// Four words (16 pixels from 16 * chunk) of frame f's row y.
__device__ __forceinline__ void compose_chunk(const Tables& tb, int f, int y,
                                              uint32_t bits, int chunk,
                                              const Consts& c,
                                              uint32_t w[4]) {
  if (in_band(y)) {
    const uint4 q = *reinterpret_cast<const uint4*>(
        &tb.fr[f].cells[(y - kBandY0) / kCellH][4 * chunk]);
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = base_word(y, 4 * chunk + k, c);
  }
  if (bits) {
    const uint2 m = sprite_masks(tb.fr[f], bits, chunk * kChunk);
    paint(w, m.x, c.pad);
    paint(w, m.y, c.ball);
  }
}

// Four words (16 pixels from 16 * chunk) of row r of the block's rows:
// frame 0's, or with `fused` the byte max of both frames' words (taken
// only where they differ).
__device__ __forceinline__ void frame_chunk(const Tables& tb, int y0, int r,
                                            int chunk, bool fused,
                                            const Consts& c, uint32_t w[4]) {
  const int y = y0 + r;
  const uint32_t bits = tb.row[r];
  compose_chunk(tb, 0, y, bits & 0x1Fu, chunk, c, w);
  if (fused) {
    uint32_t v[4];
    compose_chunk(tb, 1, y, (bits >> 8) & 0x1Fu, chunk, c, v);
    if ((w[0] ^ v[0]) | (w[1] ^ v[1]) | (w[2] ^ v[2]) | (w[3] ^ v[3])) {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = __vmaxu4(w[k], v[k]);
    }
  }
}

// Grid (n, bands): block (e, b) composes rows [b * rows, (b + 1) * rows)
// of env e's frame, rows = kH / bands.
__global__ void __launch_bounds__(kThreads)
breakout_frame_kernel(const float* __restrict__ prep,
                      uint8_t* __restrict__ out, int fused,
                      const __grid_constant__ Consts c) {
  __shared__ float4 sp[2 * kPrep / 4];
  const int frames = fused ? 2 : 1;
  const int rows = kH / gridDim.y;
  const int y0 = blockIdx.y * rows;
  load_prep(prep + static_cast<size_t>(blockIdx.x) * frames * kPrep, frames,
            sp, kThreads);
  __syncthreads();
  build_tables(reinterpret_cast<const float*>(sp), frames, y0, rows, c,
               tables, kThreads);
  __syncthreads();

  // the band's rows are contiguous: chunk i is at byte 16 * i
  uint4* band = reinterpret_cast<uint4*>(
      out + (static_cast<size_t>(blockIdx.x) * kH + y0) * kW);
  for (int i = threadIdx.x; i < rows * kRowChunks; i += kThreads) {
    const int r = i / kRowChunks;
    uint32_t w[4];
    frame_chunk(tables, y0, r, i - r * kRowChunks, fused, c, w);
    band[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One block per env: 8 blocks (32 warps) an SM, so that 1024 envs take
// one wave of the 132 SMs.
__global__ void __launch_bounds__(WarpShared::kThreads, 8)
breakout_frame_warp_kernel(const float* __restrict__ prep,
                           uint8_t* __restrict__ out,
                           const __grid_constant__ Consts c,
                           const __grid_constant__ warp84::Args a) {
  // the prep in the stages, free until the sweep
  float4* sp = reinterpret_cast<float4*>(ws.rows);
  load_prep(prep + static_cast<size_t>(blockIdx.x) * 2 * kPrep, 2, sp,
            WarpShared::kThreads);
  warp84::load_taps(ws, a);
  __syncthreads();
  build_tables(reinterpret_cast<const float*>(sp), 2, 0, kH, c, tables,
               WarpShared::kThreads);
  warp84::Cols<kWarpKX> cols;
  warp84::prepare(ws, a, cols);
  __syncthreads();
  warp84::sweep(ws, cols,
                [=](int y, int chunk, uint32_t w[4]) {
                  frame_chunk(tables, 0, y, chunk, true, c, w);
                },
                out + static_cast<size_t>(blockIdx.x) * warp84::kSize *
                          warp84::kSize);
}

// The host constants (background, wall, paddle, ball lumas) -> Consts.
Consts parse_consts(const float* consts) {
  uint32_t word[4];
  for (int k = 0; k < 4; ++k) {
    word[k] = static_cast<uint32_t>(static_cast<int>(
                  fminf(fmaxf(consts[k], 0.0f), 255.0f))) * 0x01010101u;
  }
  return Consts{word[0], word[1], word[2], word[3]};
}

}  // namespace

// prep: f32[n, fused ? 2 : 1, 464]; out: u8[n, 160, 240]; both on `device`.
// consts (host): the background, wall, paddle and ball lumas.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int breakout_frame(const float* prep, uint8_t* out, int n,
                              int fused, const float* consts, int n_consts,
                              int device, void* stream) {
  if (n_consts != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(prep) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // vector access
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const dim3 grid(n, chunk16::bands_for(n, kH, kMaxBands));
    breakout_frame_kernel<<<grid, kThreads, 0,
        static_cast<cudaStream_t>(stream)>>>(prep, out, fused,
                                             parse_consts(consts));
  }
  return static_cast<int>(cudaGetLastError());
}

// The fused frame warped in the same launch. prep: f32[n, 2, 464]; out:
// u8[n, size, size]; wy f32[size, 160], wx f32[size, 240] and taps
// i32[2, size, 2] (see warp84.cuh), all on `device`; size must be 84.
// consts as above. Launches on `stream` and returns the first CUDA error
// (0 on success).
extern "C" int breakout_frame_warp(const float* prep, uint8_t* out, int n,
                                   const float* consts, int n_consts,
                                   const float* wy, const float* wx,
                                   const int* taps, int size, int device,
                                   void* stream) {
  if (n_consts != 4 || size != warp84::kSize) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(prep) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // float4 loads
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    breakout_frame_warp_kernel<<<n, WarpShared::kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        prep, out, parse_consts(consts), warp84::Args{wy, wx, taps, size});
  }
  return static_cast<int>(cudaGetLastError());
}
