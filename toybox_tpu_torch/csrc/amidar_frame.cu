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
// whose weights made the player win overlaps. A first version here tested
// every layer at every pixel (divisions by 5 and 4 for the tile, nine
// sprites in f32, a clamp, a one-byte store), bound by instruction issue
// at 35x its byte bound (0.51 ms fused at 1024 envs). This kernel does the
// work once where it is the same, in integers:
//   - per block (one env, a band of rows), in one pass over the prep:
//     the tile codes of the board rows the band meets, four a float4 load,
//     each turned into its luma's byte (one u32 of four tile bytes); each
//     sprite's x span clipped to the frame (the ceil of the f32 edges, so
//     that it covers exactly the pixels the plain version's f32 compares
//     cover); and for each row which sprites cross it (the plain
//     version's f32 test). Then one barrier;
//   - per 16-pixel chunk of a row (10 a row). The board starts at x = 16
//     and its tiles are 4 px wide, so chunks 1-8 are the board's 128 px
//     and each aligned 4-pixel word lies in one tile: one shared load
//     gives the chunk's four tile bytes, and a byte permute replicates
//     each over its word. The enemies (their union as one 16-bit mask of
//     the chunk) and then the player (drawn last: the player wins
//     overlaps) are painted by a bit select.
// Each chunk is written with one 16-byte store; a band's rows are
// contiguous, so chunk i of a band is at byte 16 i (row pitch 160 B, frame
// 40 000 B: both multiples of 16). The lumas become their final bytes on
// the host, (uint8)(int)clamp(luma, 0, 255); truncation and the clamp are
// monotone and the kernel only selects, so the fused form's byte max
// (__vmaxu4, taken only where the two frames' words differ) equals the
// plain version's truncated max of the f32 lumas.
// Grid: blocks of 256 threads, (n, bands): chunk16::bands_for takes
// whole frames (one band) when n envs give the 132 SMs four blocks each
// (n >= 528), and up to 25 bands of 10 rows below that. The serve (n = 10) gets 250
// blocks, at least one on every SM; n = 1024 gets 1024 blocks of 9.8
// chunks a thread.
// ptxas (sm_90a): 32 registers, no stack, no spills, 4 128 B of shared
// memory.
//
// The `amidar_frame_warp` entry point composes the fused frame and warps
// it to 84 x 84 in the same launch (the `warp_to=84` form of
// `make_amidar_gray_maxpool_renderer`; the warp is in warp84.cuh). It
// takes a whole env per block, not a band: the warp needs every row. It
// still composes pixel by pixel (`pixel_luma`; its redesign is later
// work), the whole max-pooled frame into shared memory before the warp
// stage sweeps it: a word of four pixels a thread, two pixels at a time,
// with the constants in shared memory (`c.tile[code]`, an index that
// differs between lanes, is serialized by the constant bank).
// At 1024 envs on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase
// 3, torch.profiler): 390.5 us, where composing into the first version
// of the warp stage took 505.2 us.
//
// Bound on this card: bytes. At 1024 envs the fused kernel writes
// 1024 * 40000 B = 41.0 MB of frames and reads 1024 * 2 * 1024 * 4 B =
// 8.4 MB of prep: 14.7 us at 3.35 TB/s (13.5 us for one frame). Measured
// on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3, kernel time
// from torch.profiler): 22.9 us fused (64 % of the bound), 17.0 us single
// (79 %); 3.0 us fused at 10 envs. scripts/frame_kernel_variants.py shows
// what is left: with only the background stored it takes 14.0 us, the
// stores at 2.9 TB/s; the second frame's prep pass adds 3.4 us, and the
// two compositions with the max 4-6 us.

#include <cstdint>
#include <cuda_runtime.h>

#include "chunk16.cuh"
#include "warp84.cuh"

namespace {

using chunk16::chunk_mask;
using chunk16::kChunk;
using chunk16::paint;
using chunk16::span;

constexpr int kH = 250;
constexpr int kW = 160;
constexpr int kPrep = 1024;
constexpr int kBoardW = 32;
constexpr int kBoardH = 31;
constexpr int kTileW = 4;
constexpr int kTileH = 5;
constexpr int kBoardY0 = 45;
constexpr int kBoardY1 = kBoardY0 + kBoardH * kTileH;
constexpr int kBoardX0 = 16;
constexpr int kBoardX1 = kBoardX0 + kBoardW * kTileW;
constexpr int kSprite0 = 992;
constexpr int kEnemies = 8;
constexpr int kSprites = kEnemies + 1;           // then the player
constexpr int kRowChunks = kW / kChunk;          // 10
constexpr int kThreads = 256;
constexpr int kWarpKY = 6;                       // Wy taps (250 -> 84)
constexpr int kWarpKX = 4;                       // Wx taps (160 -> 84)
constexpr int kMaxBands = 25;                    // bands of >= 10 rows
constexpr int kTileWords = kBoardW / 4;          // a board row's words
constexpr int kConsts = 6;

static_assert(kRowChunks * kChunk == kW, "chunks must tile a row");
static_assert(kH % kMaxBands == 0, "the most bands must tile the frame");
static_assert(kW % 16 == 0 && (kH * kW) % 16 == 0, "16-byte stores");
static_assert(kPrep % 4 == 0 && kTileWords * 4 == kBoardW, "float4 loads");
static_assert(kBoardX0 % kChunk == 0 && (kBoardX1 - kBoardX0) % kChunk == 0
              && kChunk == 4 * kTileW, "a chunk is 4 whole tiles");

struct Consts {
  float tile[4];          // f32 lumas by tile code (the warp entry)
  float enemy, player;
  uint32_t tile_bytes;    // byte k: the luma byte of tile code k
  uint32_t bg_word, enemy_word, player_word;  // bytes replicated 4 times
};

// The warp entry's stage (see warp84.cuh): 12 warps a block, on the whole
// frame composed first, in dynamic shared memory (above 48 KB).
using WarpShared = warp84::Shared<kH, kW, kWarpKY, 12, 0>;

// ---------------------------------------------------------------------------
// The per-pixel composition of the warp entry point
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool covers(const float* s, float fx, float fy) {
  return fx >= s[0] && fx < s[0] + 4.0f && fy >= s[1] && fy < s[1] + 5.0f &&
         s[2] > 0.0f;
}

__device__ __forceinline__ float pixel_luma(const float* p, int y, int x,
                                            const Consts& c) {
  float v = c.tile[0];
  if (y >= kBoardY0 && y < kBoardY1 && x >= kBoardX0 && x < kBoardX1) {
    const int code = static_cast<int>(
        p[((y - kBoardY0) / kTileH) * kBoardW + (x - kBoardX0) / kTileW]);
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

// ---------------------------------------------------------------------------
// The row-culled composition of the frame entry point
// ---------------------------------------------------------------------------

struct Frame {          // one frame's block-wide tables, in shared memory
  uint32_t tiles[kBoardH][kTileWords];  // 4 tile bytes a word (the band's
                                        // board rows only)
  int2 xspan[kSprites];
  uint32_t row[kH];                     // sprites crossing the band's row
};

// The board row of pixel row y, or -1 off the board.
__device__ __forceinline__ int board_row(int y) {
  return y >= kBoardY0 && y < kBoardY1 ? (y - kBoardY0) / kTileH : -1;
}

// Grid (n, bands): block (e, b) composes rows [b * rows, (b + 1) * rows)
// of env e's frame, rows = kH / bands.
__global__ void __launch_bounds__(kThreads)
amidar_frame_kernel(const float* __restrict__ prep,
                    uint8_t* __restrict__ out, int fused,
                    const __grid_constant__ Consts c) {
  __shared__ Frame fr[2];
  const int frames = fused ? 2 : 1;
  const int t = threadIdx.x;
  const float* src = prep + static_cast<size_t>(blockIdx.x) * frames * kPrep;
  const int rows = kH / gridDim.y;
  const int y0 = blockIdx.y * rows;
  // the board rows [tile0, tile1) that the band meets
  const int tile0 = board_row(max(y0, kBoardY0));
  const int tile1 = board_row(min(y0 + rows, kBoardY1) - 1) + 1;
  const int tile_items = tile0 >= 0 && tile1 > tile0
                             ? (tile1 - tile0) * kTileWords : 0;

  // one pass over the prep (from L2), about one item a thread: the band's
  // tile bytes (4 tile codes a float4 load -> one word), the sprites' x
  // spans, and which sprites cross each row (the plain version's f32 test
  // of the sprite's rows)
  const int items = tile_items + kSprites + rows;
  for (int i = t; i < frames * items; i += kThreads) {
    const int f = i / items;
    const int j = i - f * items;
    const float* p = src + f * kPrep;
    if (j < tile_items) {
      const int word = tile0 * kTileWords + j;
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + word);
      const float codes[4] = {q.x, q.y, q.z, q.w};
      uint32_t bytes = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int code = min(max(static_cast<int>(codes[k]), 0), 3);
        bytes |= ((c.tile_bytes >> (8 * code)) & 0xFFu) << (8 * k);
      }
      (&fr[f].tiles[0][0])[word] = bytes;
    } else if (j < tile_items + kSprites) {
      const int k = j - tile_items;
      const float* s = p + kSprite0 + 3 * k;
      fr[f].xspan[k] = __ldg(s + 2) > 0.0f ? span(__ldg(s), kTileW, kW)
                                           : make_int2(0, 0);
    } else {
      const int r = j - tile_items - kSprites;
      const float fy = static_cast<float>(y0 + r);
      uint32_t bits = 0;
#pragma unroll
      for (int k = 0; k < kSprites; ++k) {
        const float* s = p + kSprite0 + 3 * k;
        const float sy = __ldg(s + 1);
        bits |= static_cast<uint32_t>(fy >= sy && fy < sy + kTileH &&
                                      __ldg(s + 2) > 0.0f) << k;
      }
      fr[f].row[r] = bits;
    }
  }
  __syncthreads();

  // the band's rows are contiguous: chunk i is at byte 16 * i
  uint4* band = reinterpret_cast<uint4*>(
      out + (static_cast<size_t>(blockIdx.x) * kH + y0) * kW);
  for (int i = t; i < rows * kRowChunks; i += kThreads) {
    const int r = i / kRowChunks;
    const int x0 = (i - r * kRowChunks) * kChunk;
    const int tr = board_row(y0 + r);
    const bool on_board = tr >= 0 && x0 >= kBoardX0 && x0 < kBoardX1;
    const int tile_word = (x0 - kBoardX0) / kChunk;
    uint32_t w[4];
    for (int f = 0; f < frames; ++f) {
      uint32_t v[4];
      if (on_board) {
        const uint32_t tb = fr[f].tiles[tr][tile_word];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = __byte_perm(tb, 0, 0x1111u * k);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = c.bg_word;
      }
      uint32_t enemies = 0, player = 0;
      for (uint32_t b = fr[f].row[r]; b; b &= b - 1) {
        const int k = __ffs(b) - 1;
        const uint32_t m = chunk_mask(fr[f].xspan[k].x, fr[f].xspan[k].y,
                                      x0);
        if (k < kEnemies) {
          enemies |= m;
        } else {
          player = m;
        }
      }
      paint(v, enemies, c.enemy_word);
      paint(v, player, c.player_word);
      if (f == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = v[k];
      } else if ((w[0] ^ v[0]) | (w[1] ^ v[1]) | (w[2] ^ v[2]) |
                 (w[3] ^ v[3])) {
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = __vmaxu4(w[k], v[k]);
      }
    }
    band[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__global__ void __launch_bounds__(WarpShared::kThreads, 2)
amidar_frame_warp_kernel(const float* __restrict__ prep,
                         uint8_t* __restrict__ out, Consts c,
                         warp84::Args a) {
  extern __shared__ float4 smem4[];
  WarpShared& ws = *reinterpret_cast<WarpShared*>(smem4);
  __shared__ float sp[2 * kPrep];
  // the constants in shared memory: pixel_luma indexes them by a value
  // that differs between lanes, which the constant bank serializes
  __shared__ Consts sc;
  const float* src = prep + static_cast<size_t>(blockIdx.x) * 2 * kPrep;
  for (int i = threadIdx.x; i < 2 * kPrep; i += WarpShared::kThreads) {
    sp[i] = src[i];
  }
  if (threadIdx.x == 0) sc = c;
  warp84::load_taps(ws, a);
  __syncthreads();
  // the max-pooled frame into the stage's frame rows, a word of four
  // pixels a thread, two pixels at a time
  uint32_t* img = reinterpret_cast<uint32_t*>(warp84::frame(ws));
#pragma unroll 1
  for (int i = threadIdx.x; i < kH * kW / 4; i += WarpShared::kThreads) {
    const int y = i / (kW / 4);
    const int x0 = 4 * (i - y * (kW / 4));
    uint32_t word = 0;
#pragma unroll 2
    for (int b = 0; b < 4; ++b) {
      word |= static_cast<uint32_t>(static_cast<int>(
          fmaxf(pixel_luma(sp, y, x0 + b, sc),
                pixel_luma(sp + kPrep, y, x0 + b, sc)))) << (8 * b);
    }
    img[i] = word;
  }
  warp84::Cols<kWarpKX> cols;
  warp84::prepare(ws, a, cols);
  __syncthreads();
  warp84::sweep(ws, cols, warp84::NoCompose{},
                out + static_cast<size_t>(blockIdx.x) * warp84::kSize *
                          warp84::kSize);
}

// The host constants (see amidar_frame below) -> Consts; false if
// malformed.
bool parse_consts(const float* consts, int n_consts, Consts* c) {
  if (n_consts != kConsts) return false;
  uint32_t bytes[kConsts];
  for (int k = 0; k < kConsts; ++k) {
    bytes[k] = static_cast<uint32_t>(
        static_cast<int>(fminf(fmaxf(consts[k], 0.0f), 255.0f)));
  }
  for (int k = 0; k < 4; ++k) c->tile[k] = consts[k];
  c->enemy = consts[4];
  c->player = consts[5];
  c->tile_bytes = bytes[0] | (bytes[1] << 8) | (bytes[2] << 16) |
                  (bytes[3] << 24);
  c->bg_word = bytes[0] * 0x01010101u;
  c->enemy_word = bytes[4] * 0x01010101u;
  c->player_word = bytes[5] * 0x01010101u;
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
  if (reinterpret_cast<uintptr_t>(prep) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // vector access
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const dim3 grid(n, chunk16::bands_for(n, kH, kMaxBands));
    amidar_frame_kernel<<<grid, kThreads, 0,
        static_cast<cudaStream_t>(stream)>>>(prep, out, fused, c);
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
  if (!parse_consts(consts, n_consts, &c) || size != warp84::kSize) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = warp84::allow_smem(
      reinterpret_cast<const void*>(amidar_frame_warp_kernel),
      sizeof(WarpShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    amidar_frame_warp_kernel<<<n, WarpShared::kThreads, sizeof(WarpShared),
                               static_cast<cudaStream_t>(stream)>>>(
        prep, out, c, warp84::Args{wy, wx, taps, size});
  }
  return static_cast<int>(cudaGetLastError());
}
