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
// A first version here tested every layer at every pixel (a division by
// the width, the anchor's conversion, the formation cell's division, three
// shields, seven sprites in f32, a clamp, a one-byte store): some 150-300
// instructions a pixel, bound by instruction issue at 60x its byte bound
// (1.24 ms fused at 1024 envs). Nearly all of that work is the same along
// a row or a whole frame, so this kernel does it once there, in integers:
//   - per block (one env, a band of rows), in one pass over the prep:
//     each sprite's x span [x0, x1) clipped to the frame (the ceil of the
//     f32 edges, so that it covers exactly the pixels the plain version's
//     f32 compares cover), the formation anchor, and for each row a
//     descriptor (16 B in shared memory): the 6-bit show mask of the
//     formation cell row the row lies in (0 off the cells), which sprites
//     cross the row (the plain version's f32 test), and the three shields'
//     16-bit row masks when the row is in the shields' band. Then one
//     barrier;
//   - per 16-pixel chunk of a row (20 a row): each layer in draw order
//     (formation, shields, UFO, ship, lasers) becomes a 16-bit mask of the
//     chunk from integer interval tests (a chunk meets at most one
//     formation cell: cells are 16 wide, 32 apart), and is painted into
//     four u32 words of four pixels each by a bit select against the
//     layer's byte replicated four times. The last shield whose 16 x 18
//     rectangle holds a pixel decides it, bit 0 or 1, as the plain version
//     assigns each rectangle in turn.
// Each chunk is written with one 16-byte store; a band's rows are
// contiguous, so chunk i of a band is at byte 16 i (row pitch 320 B, frame
// 67 200 B: both multiples of 16). The lumas become their final bytes on
// the host, (uint8)(int)clamp(luma, 0, 255); truncation and the clamp are
// monotone and the kernel only selects, so the fused form's byte max
// (__vmaxu4, taken only where the two frames' words differ) equals the
// plain version's truncated max of the f32 lumas.
// Grid: blocks of 512 threads, (n, bands): chunk16::bands_for takes whole
// frames (one band) when n envs give the 132 SMs four blocks each
// (n >= 528: 2048 threads an SM), and up to 14 bands of 15 rows below
// that. The
// serve (n = 10) gets 140 blocks, at least one on every SM; n = 1024 gets
// 1024 blocks of 8.2 chunks a thread.
// ptxas (sm_90a): 32 registers, no stack, no spills, 6 848 B of shared
// memory.
//
// The `si_frame_warp` entry point composes the fused frame and warps it to
// 84 x 84 in the same launch (the `warp_to=84` form of
// `make_si_gray_maxpool_renderer`; the warp stage is in warp84.cuh). Its
// blocks take one env each (4 warps) and build the same tables for the
// whole frame (210 row descriptors a frame, 6.8 KB); the stage composes
// the frame by the same 16-pixel chunks (`frame_chunk`), 8 rows at a time
// into each warp's own stage, and never holds it. A first version
// composed it pixel by pixel in f32 (the per-pixel tests above, a word of
// four pixels a thread) into 89.4 KB of dynamic shared memory before 12
// warps swept it: 2 blocks an SM.
//
// Bound on this card: bytes. At 1024 envs the fused kernel writes
// 1024 * 67200 B = 68.8 MB of frames and reads 1024 * 2 * 128 * 4 B =
// 1.0 MB of prep: 20.9 us at 3.35 TB/s (20.7 us for one frame). Measured
// on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3, kernel time
// from torch.profiler): 32.9 us fused (64 % of the bound), 26.1 us single
// (79 %); 3.4 us fused at 10 envs. scripts/frame_kernel_variants.py shows
// what is left: with only the background stored (the prep pass and the
// stores kept) it takes 22.4 us, the 16-byte stores at 3.1 TB/s; the
// first frame's composition adds 3.9 us and the second frame's with the
// max 6.3 us, issue that the stores no longer hide.
// The warp entry writes 7 056 B an env: its ordered multiplies and adds
// bound it (8.8 us at 1024 envs, warp84.cuh). Measured on the same card
// (chip_smoke.py phase 3): 105.2 us at 1024 envs, 11.9x the bound and 9x
// faster than the per-pixel version (959.0-976.5 us against 103.6-103.9
// us in one call of scripts/frame_kernel_variants.py). The variants show
// two halves that do not hide each other: with the frame left as the
// background (the contraction and the stage stores) it takes 62.6 us,
// and composing without the contraction 63.6 us. ptxas (sm_90a):
// 95 registers, no spills, 28 640 B of static shared memory, 5 blocks
// (20 warps) an SM by its launch bound. 4-6 blocks time alike (98.4-103.5
// us in one call; at 6 it gets 80 registers and spills 8 B), 7 and 8
// spill 40 and 72 B and take 111.5 and 117.6 us.

#include <cstdint>
#include <cuda_runtime.h>

#include "chunk16.cuh"
#include "warp84.cuh"

namespace {

using chunk16::chunk_mask;
using chunk16::kChunk;
using chunk16::paint;
using chunk16::span;

constexpr int kH = 210;
constexpr int kW = 320;
constexpr int kPrep = 128;
constexpr int kShieldRows = 0;
constexpr int kShow = 54;
constexpr int kAnchor = 90;
constexpr int kSprite0 = 92;
constexpr int kSprites = 7;
constexpr int kMaxShields = 3;
constexpr int kRowChunks = kW / kChunk;          // 20
constexpr int kThreads = 512;
constexpr int kWarpKY = 5;                       // Wy taps (210 -> 84)
constexpr int kWarpKX = 8;                       // Wx taps (320 -> 84)
constexpr int kMaxBands = 14;                    // bands of >= 15 rows
constexpr int kWarpRows = 8;                     // rows composed ahead
constexpr int kWarpBlocks = 5;                   // warp blocks an SM
constexpr int kConsts = 11;
// formation geometry (games/space_invaders.py)
constexpr int kCols = 6, kRows = 6, kCellW = 16, kCellH = 10, kDX = 32,
              kDY = 18;
// An anchor beyond this is clamped: the formation is then off the frame
// either way, and x - anchor cannot overflow.
constexpr float kFar = 1024.0f;

static_assert(kRowChunks * kChunk == kW, "chunks must tile a row");
static_assert(kH % kMaxBands == 0, "the most bands must tile the frame");
static_assert(kW % 16 == 0 && (kH * kW) % 16 == 0, "16-byte stores");
static_assert(kDX == 2 * kCellW && kDX == 32, "one cell a chunk, x >> 5");

enum Layer { kBg, kEnemy, kShield, kUfo, kShip, kLaser, kLayers };

struct Consts {
  uint32_t word[kLayers];    // each luma's byte, replicated 4 times
  int n_shields, shield_y;
  int shield_x[kMaxShields];
};

struct Frame {          // one frame's block-wide tables, in shared memory
  int2 xspan[kSprites];
  int anchor_x;
  uint4 row[kH];         // x: formation show bits [0, 6) and sprites
                         // crossing the row [8, 15); y: shield 0 | 1 << 16
                         // row masks; z: shield 2 | in the band << 16
};

// The warp entry's stage (see warp84.cuh): 4 warps a block, each composing
// 8 rows ahead.
using WarpShared = warp84::Shared<kH, kW, kWarpKY, 4, kWarpRows>;

// The kernels' shared memory, at namespace scope so that the warp stage's
// composition callback reads it without a capture.
__shared__ Frame tables[2];
__shared__ WarpShared ws;

// Sprite t's x span (t < kSprites) or the anchor's x (t == kSprites) of
// frame p.
__device__ __forceinline__ void frame_span(const float* __restrict__ p,
                                           int t, Frame& fr) {
  if (t < kSprites) {
    const float* s = p + kSprite0 + 3 * t;
    fr.xspan[t] = __ldg(s + 2) > 0.0f ? span(__ldg(s), t < 2 ? 16.0f : 2.0f,
                                             kW)
                                      : make_int2(0, 0);
  } else {
    fr.anchor_x = static_cast<int>(
        fminf(fmaxf(__ldg(p + kAnchor), -kFar), kFar));
  }
}

// The descriptor of row y of frame p.
__device__ __forceinline__ uint4 row_descriptor(const float* __restrict__ p,
                                                int y, const Consts& c) {
  uint32_t bits = 0;
  const int ay = static_cast<int>(
      fminf(fmaxf(__ldg(p + kAnchor + 1), -kFar), kFar));
  const int ry = y - ay;
  if (ry >= 0 && ry < kRows * kDY) {
    const int q = ry / kDY;
    if (ry - q * kDY < kCellH) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        bits |= static_cast<uint32_t>(__ldg(p + kShow + q * kCols + k) >
                                      0.0f) << k;
      }
    }
  }
  // the plain version's f32 test of the sprite's rows
  const float fy = static_cast<float>(y);
#pragma unroll
  for (int k = 0; k < kSprites; ++k) {
    const float* s = p + kSprite0 + 3 * k;
    const float sy = __ldg(s + 1);
    bits |= static_cast<uint32_t>(fy >= sy && fy < sy + (k < 2 ? 10.0f : 8.0f)
                                  && __ldg(s + 2) > 0.0f) << (8 + k);
  }
  uint32_t sh[kMaxShields] = {0, 0, 0};
  uint32_t in_band = 0;
  const int sy = y - c.shield_y;
  if (sy >= 0 && sy < 18 && c.n_shields > 0) {
    in_band = 1;
#pragma unroll
    for (int s = 0; s < kMaxShields; ++s) {
      if (s < c.n_shields) {
        sh[s] = static_cast<uint32_t>(static_cast<int>(
                    __ldg(p + kShieldRows + 18 * s + sy))) & 0xFFFFu;
      }
    }
  }
  return make_uint4(bits, sh[0] | (sh[1] << 16), sh[2] | (in_band << 16), 0);
}

// Four words (16 pixels from x0) of one frame's row, given its descriptor.
__device__ __forceinline__ void compose_chunk(const uint4 d, int x0,
                                              const Frame& fr,
                                              const Consts& c,
                                              uint32_t w[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = c.word[kBg];

  const uint32_t show = d.x & 0x3Fu;
  if (show) {
    // the one cell that can meet [x0, x0 + 16): floor((x0 - ax + 15) / 32)
    const int ax = fr.anchor_x;
    const int k = (x0 - ax + kChunk - 1) >> 5;
    if (k >= 0 && k < kCols && ((show >> k) & 1u)) {
      paint(w, chunk_mask(ax + kDX * k, ax + kDX * k + kCellW, x0),
            c.word[kEnemy]);
    }
  }

  if (d.z >> 16) {
    uint32_t m = 0;
    const uint32_t rows[kMaxShields] = {d.y & 0xFFFFu, d.y >> 16,
                                        d.z & 0xFFFFu};
#pragma unroll
    for (int s = 0; s < kMaxShields; ++s) {
      if (s < c.n_shields) {
        const int sx = c.shield_x[s];
        const uint32_t cov = chunk_mask(sx, sx + 16, x0);
        if (cov) {  // then |sx - x0| < 16
          const int shift = sx - x0;
          const uint32_t bits =
              shift >= 0 ? rows[s] << shift : rows[s] >> -shift;
          m = (m & ~cov) | (bits & cov);
        }
      }
    }
    paint(w, m, c.word[kShield]);
  }

  uint32_t ufo = 0, ship = 0, laser = 0;
  for (uint32_t b = (d.x >> 8) & 0x7Fu; b; b &= b - 1) {
    const int k = __ffs(b) - 1;
    const uint32_t m = chunk_mask(fr.xspan[k].x, fr.xspan[k].y, x0);
    if (k == 0) {
      ufo |= m;
    } else if (k == 1) {
      ship |= m;
    } else {
      laser |= m;
    }
  }
  paint(w, ufo, c.word[kUfo]);
  paint(w, ship, c.word[kShip]);
  paint(w, laser, c.word[kLaser]);
}

// Four words (16 pixels from x0) of row r of the block's rows: frame 0's,
// or with `fused` the byte max of both frames' words (taken only where
// they differ).
__device__ __forceinline__ void frame_chunk(const Frame fr[2], int r, int x0,
                                            bool fused, const Consts& c,
                                            uint32_t w[4]) {
  compose_chunk(fr[0].row[r], x0, fr[0], c, w);
  if (fused) {
    uint32_t v[4];
    compose_chunk(fr[1].row[r], x0, fr[1], c, v);
    if ((w[0] ^ v[0]) | (w[1] ^ v[1]) | (w[2] ^ v[2]) | (w[3] ^ v[3])) {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = __vmaxu4(w[k], v[k]);
    }
  }
}

// One pass over the prep of `frames` frames at src (from L2) for rows
// [y0, y0 + rows), by the block's nthreads threads: the row descriptors,
// then the sprites' x spans and the anchor's x.
__device__ __forceinline__ void build_tables(const float* __restrict__ src,
                                             int frames, int y0, int rows,
                                             const Consts& c, Frame fr[2],
                                             int nthreads) {
  const int items = rows + kSprites + 1;
  for (int i = threadIdx.x; i < frames * items; i += nthreads) {
    const int f = i / items;
    const int j = i - f * items;
    if (j < rows) {
      fr[f].row[j] = row_descriptor(src + f * kPrep, y0 + j, c);
    } else {
      frame_span(src + f * kPrep, j - rows, fr[f]);
    }
  }
}

// Grid (n, bands): block (e, b) composes rows [b * rows, (b + 1) * rows)
// of env e's frame, rows = kH / bands.
__global__ void __launch_bounds__(kThreads)
si_frame_kernel(const float* __restrict__ prep, uint8_t* __restrict__ out,
                int fused, const __grid_constant__ Consts c) {
  const int frames = fused ? 2 : 1;
  const int rows = kH / gridDim.y;
  const int y0 = blockIdx.y * rows;
  build_tables(prep + static_cast<size_t>(blockIdx.x) * frames * kPrep,
               frames, y0, rows, c, tables, kThreads);
  __syncthreads();

  // the band's rows are contiguous: chunk i is at byte 16 * i
  uint4* band = reinterpret_cast<uint4*>(
      out + (static_cast<size_t>(blockIdx.x) * kH + y0) * kW);
  for (int i = threadIdx.x; i < rows * kRowChunks; i += kThreads) {
    const int r = i / kRowChunks;
    uint32_t w[4];
    frame_chunk(tables, r, (i - r * kRowChunks) * kChunk, fused, c, w);
    band[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One block per env (see the note for its footprint).
__global__ void __launch_bounds__(WarpShared::kThreads, kWarpBlocks)
si_frame_warp_kernel(const float* __restrict__ prep,
                     uint8_t* __restrict__ out,
                     const __grid_constant__ Consts c,
                     const __grid_constant__ warp84::Args a) {
  warp84::load_taps(ws, a);
  __syncthreads();
  build_tables(prep + static_cast<size_t>(blockIdx.x) * 2 * kPrep, 2, 0, kH,
               c, tables, WarpShared::kThreads);
  warp84::Cols<kWarpKX> cols;
  warp84::prepare(ws, a, cols);
  __syncthreads();
  warp84::sweep(ws, cols,
                [=](int y, int chunk, uint32_t w[4]) {
                  frame_chunk(tables, y, chunk * kChunk, true, c, w);
                },
                out + static_cast<size_t>(blockIdx.x) * warp84::kSize *
                          warp84::kSize);
}

// The host constants (see si_frame below) -> Consts; false if malformed.
bool parse_consts(const float* consts, int n_consts, Consts* c) {
  if (n_consts != kConsts) return false;
  for (int k = 0; k < kLayers; ++k) {
    const uint32_t byte = static_cast<uint32_t>(
        static_cast<int>(fminf(fmaxf(consts[k], 0.0f), 255.0f)));
    c->word[k] = byte * 0x01010101u;
  }
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
  if (reinterpret_cast<uintptr_t>(prep) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // vector access
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const dim3 grid(n, chunk16::bands_for(n, kH, kMaxBands));
    si_frame_kernel<<<grid, kThreads, 0,
        static_cast<cudaStream_t>(stream)>>>(prep, out, fused, c);
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
  if (!parse_consts(consts, n_consts, &c) || size != warp84::kSize) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    si_frame_warp_kernel<<<n, WarpShared::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        prep, out, c, warp84::Args{wy, wx, taps, size});
  }
  return static_cast<int>(cudaGetLastError());
}
