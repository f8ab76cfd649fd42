// The in-kernel warp of the fused frame kernels for Hopper (sm_90a),
// shared by csrc/breakout_frame.cu, csrc/si_frame.cu and
// csrc/amidar_frame.cu (their `<name>_warp` entry points).
//
// Replaces the `warp_to` branch of the TPU kernel body in
// toybox_tpu/ops/render_pallas.py `_frame_call` (:80-112), as reached from
// `make_breakout_gray_maxpool_renderer` (:324),
// `make_amidar_gray_maxpool_renderer` (:489) and
// `make_si_gray_maxpool_renderer` (:722) with warp_to=84: the max of two
// composed frames, truncated to an integer, warped to 84 x 84 as
// Wy.img.Wx^T in f32, rounded half to even and clipped to [0, 255].
//
// The order of the sums: t[i, x] = sum_y Wy[i, y] img[y, x], then
// out[i, j] = sum_x Wx[j, x] t[i, x] (the JAX `oh,hw,pw` einsum), each
// sum in increasing index order from +0, one rounded f32 multiply and one
// rounded add per term (__fmul_rn, __fadd_rn: never contracted into an
// FMA). Every weight is >= 0 and zero outside its row's band (ops/obs.py
// `WarpTables`), so terms of zero weight before or after a band add +0
// and leave the sum as it is: the result equals the plain PyTorch version
// (ops/obs.py `banded_warp`) bit for bit.
//
// Design: one block per env, WARPS warps, each warp on its own 84 / WARPS
// output rows, warp-synchronous after the set-up:
//   - set-up (once a block, between two barriers): the tap ranges, then
//     each Wy row's band (at most KY weights) into shared memory, and for
//     each lane the Wx bands of its <= 3 output columns (KX weights and a
//     start each) into registers. The tables are checked against what the
//     sweep assumes (below); a table that breaks it stops the kernel
//     (__trap), as a device-side assert does;
//   - the sweep: the warp walks the input rows of its output rows' bands
//     once, in increasing y. Every input row lies in the bands of at most
//     two output rows (true of obs.bilinear_matrix at every frame size
//     here: 160-320 -> 84, each band 3-8 wide), so each lane keeps two
//     accumulators per column of its words (4 columns a word), for the
//     open output row and the next, and converts each byte to f32 once (a
//     byte permute into 0x4B0000bb and one f32 subtract of 2^23, on the
//     FP32 pipe: no I2F) before adding it, times the row's weight, into
//     both;
//   - when the sweep passes the last row of the open output row i, t[i, :]
//     is complete: the lanes write it to the warp's shared t row, and the
//     warp takes out[i, :] from it at once, a lane per output column, KX
//     ordered terms each (a start at min(first, W - KX), so that every
//     read lies in the row: the terms outside the band have weight 0),
//     then rounded half to even (the sum is >= 0: one f32-to-u32
//     conversion), clipped, one byte stored.
// The rows the sweep reads come from the game: every STAGE_ROWS rows the
// warp's 32 lanes compose the next rows in 16-pixel chunks (the game's
// callback) into the warp's own stage, all lanes busy whatever the width.
// The frame is never held, so the shared memory stays small and many
// blocks share an SM (each game's file gives its footprint).
// What the sweep assumes of the tables, checked in the set-up: every band
// holds 1..KY (rows) or 1..KX (columns) taps inside the frame; the bands'
// first rows never decrease and their last rows increase; and band i + 2
// starts after band i ends (no input row in three bands).
// The first version of this stage held the whole frame and an f32
// t[84, W] in one 512-thread block (Breakout 119 040 B: one block an SM),
// read every weight from global memory per tap and converted every
// byte per tap (I2F); a second one, for Space Invaders and Amidar,
// composed the whole frame per pixel into shared memory before 12 warps
// swept it (89.4 and 56.2 KB, 2 blocks an SM).
//
// Bound on this card: operations (at 1024 envs the bands' ordered
// multiplies and adds, 0.21-0.37 M per env, take 3.3-5.7 us at 67 TFLOP/s,
// and the composition's selects add a third; the prep read and the 7 056 B
// per env written take 1-3 us at 3.35 TB/s). The measured times, against
// that bound, are in each game's file.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace warp84 {

constexpr int kSize = 84;                        // output rows and columns
constexpr int kColsPerLane = (kSize + 31) / 32;  // 3 output columns a lane

struct Args {
  const float* wy;  // f32[size, H]
  const float* wx;  // f32[size, W]
  const int* taps;  // i32[2, size, 2]: (first, count) of each Wy row, then
                    // of each Wx row
  int size;
};

// Byte b of `word` as f32, exactly, on the FP32 pipe (see above).
__device__ __forceinline__ float byte_float(uint32_t word, int b) {
  return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u,
                                               0x7440u | b)),
                   8388608.0f);
}

// The stage's shared memory, declared by the kernel at namespace scope.
// H x W is the frame, KY bounds the taps of a Wy row, WARPS is the block's
// warps (one env; each warp takes 84 / WARPS output rows), and each warp
// composes the next STAGE_ROWS input rows into its own stage as it goes.
template <int H, int W, int KY, int WARPS, int STAGE_ROWS>
struct Shared {
  static constexpr int kH = H, kW = W, kKY = KY, kWarps = WARPS;
  static constexpr int kStageRows = STAGE_ROWS;
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kRowsPerWarp = kSize / WARPS;
  static constexpr int kChunks = W / 16;                 // chunks a row
  static constexpr int kWords = W / 4;                   // words a row
  static constexpr int kLaneWords = (kWords + 31) / 32;  // a lane's words
  // a stage row's words: the row, then pad words (read into accumulators
  // that are never used: any bytes are finite)
  static constexpr int kPadWords = 32 * kLaneWords;
  static_assert(W % 16 == 0 && H >= KY, "frame too small or not in chunks");
  static_assert(kRowsPerWarp * WARPS == kSize, "warps must tile the rows");
  static_assert(STAGE_ROWS > 0, "a stage holds at least one row");
  uint4 rows[WARPS * STAGE_ROWS * kPadWords / 4];  // the stages
  float4 t[WARPS][kPadWords];                // a t row, 4 columns a float4
  float wy[kSize][KY];                       // Wy[i, ys[i] + k]
  int ys[kSize];                             // min(first_i, H - KY)
  int2 taps[2][kSize];                       // (first, count)
};

// A lane's Wx bands, in registers: output column lane + 32 q takes
// Wx[j, x0[q] + k], k < KX.
template <int KX>
struct Cols {
  float w[kColsPerLane][KX];
  int x0[kColsPerLane];
};

// The three phases, each called from all S::kThreads threads of the block:
//   load_taps(s, a)        before the block's first barrier;
//   prepare(s, a, cols)    between the first and the second barrier;
//   sweep(s, cols, compose, dst)  after the second.
// Until sweep() the stages are free for the caller's set-up (`rows`,
// sizeof(S::rows) bytes).

template <class S>
__device__ __forceinline__ void load_taps(S& s, const Args& a) {
  for (int i = threadIdx.x; i < 2 * kSize; i += S::kThreads) {
    s.taps[i / kSize][i % kSize] =
        make_int2(__ldg(a.taps + 2 * i), __ldg(a.taps + 2 * i + 1));
  }
}

// Checks the tables (see the note), takes Wy's bands into s and the lane's
// Wx bands into cols.
template <int KX, class S>
__device__ __forceinline__ void prepare(S& s, const Args& a, Cols<KX>& cols) {
  constexpr int H = S::kH, W = S::kW, KY = S::kKY;
  static_assert(W >= KX, "frame too small");
  for (int i = threadIdx.x; i < kSize; i += S::kThreads) {
    const int2 ty = s.taps[0][i];
    const int2 tx = s.taps[1][i];
    bool ok = ty.y >= 1 && ty.y <= KY && ty.x >= 0 && ty.x + ty.y <= H &&
              tx.y >= 1 && tx.y <= KX && tx.x >= 0 && tx.x + tx.y <= W;
    if (i + 1 < kSize) {
      const int2 next = s.taps[0][i + 1];
      ok = ok && next.x >= ty.x && next.x + next.y > ty.x + ty.y;
    }
    if (i + 2 < kSize) ok = ok && s.taps[0][i + 2].x >= ty.x + ty.y;
    if (!ok) __trap();
    const int y0 = min(ty.x, H - KY);
    s.ys[i] = y0;
#pragma unroll
    for (int k = 0; k < KY; ++k) {
      s.wy[i][k] = __ldg(a.wy + static_cast<size_t>(i) * H + y0 + k);
    }
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kColsPerLane; ++q) {
    const int j = min(lane + 32 * q, kSize - 1);  // lanes past 83 idle
    cols.x0[q] = min(s.taps[1][j].x, W - KX);
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      cols.w[q][k] = __ldg(a.wx + static_cast<size_t>(j) * W + cols.x0[q] + k);
    }
  }
}

// Writes u8[84, 84] to dst, the warp of the frame that compose(y, chunk,
// w) gives: w[k] the max-pooled, truncated bytes of pixels
// 16 chunk + 4 k .. 16 chunk + 4 k + 3 of row y (byte b = pixel
// 16 chunk + 4 k + b).
template <int KX, class S, class Compose>
__device__ __forceinline__ void sweep(S& s, const Cols<KX>& cols,
                                      Compose compose,
                                      uint8_t* __restrict__ dst) {
  constexpr int H = S::kH, kChunks = S::kChunks;
  constexpr int kLaneWords = S::kLaneWords, kBatch = S::kStageRows;
  const int lane = threadIdx.x & 31;
  const int wp = threadIdx.x >> 5;

  // this warp's output rows [r0, r1)
  const int r0 = wp * S::kRowsPerWarp;
  const int r1 = r0 + S::kRowsPerWarp;
  const int y_begin = s.taps[0][r0].x;
  const int y_end = s.taps[0][r1 - 1].x + s.taps[0][r1 - 1].y;
  int cur = r0;                          // the open output row
  int last = s.taps[0][cur].x + s.taps[0][cur].y - 1;
  int ys0 = s.ys[cur];
  int ys1 = cur + 1 < r1 ? s.ys[cur + 1] : H;  // the next row's (or none)
  float acc0[kLaneWords][4], acc1[kLaneWords][4];
#pragma unroll
  for (int p = 0; p < kLaneWords; ++p) {
#pragma unroll
    for (int b = 0; b < 4; ++b) acc0[p][b] = acc1[p][b] = 0.0f;
  }
  uint4* stage = s.rows + wp * (kBatch * S::kPadWords / 4);
  float4* t = s.t[wp];

  for (int yb = y_begin; yb < y_end; yb += kBatch) {
    const int rows = min(kBatch, y_end - yb);
    __syncwarp();                          // the last stage has been read
    for (int k = lane; k < rows * kChunks; k += 32) {
      const int r = k / kChunks;
      const int chunk = k - r * kChunks;
      uint32_t w[4];
      compose(yb + r, chunk, w);
      stage[r * (S::kPadWords / 4) + chunk] =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncwarp();
    for (int r = 0; r < rows; ++r) {
      const int y = yb + r;
      const float w0 = y >= ys0 ? s.wy[cur][y - ys0] : 0.0f;
      const float w1 = y >= ys1 ? s.wy[cur + 1][y - ys1] : 0.0f;
      const uint32_t* row =
          reinterpret_cast<const uint32_t*>(stage) + r * S::kPadWords;
#pragma unroll
      for (int p = 0; p < kLaneWords; ++p) {
        const uint32_t word = row[lane + 32 * p];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float v = byte_float(word, b);
          acc0[p][b] = __fadd_rn(acc0[p][b], __fmul_rn(w0, v));
          acc1[p][b] = __fadd_rn(acc1[p][b], __fmul_rn(w1, v));
        }
      }
      if (y != last) continue;

      // t[cur, :] is complete: the columns of output row cur
#pragma unroll
      for (int p = 0; p < kLaneWords; ++p) {
        t[lane + 32 * p] =
            make_float4(acc0[p][0], acc0[p][1], acc0[p][2], acc0[p][3]);
      }
      __syncwarp();
      const float* tf = reinterpret_cast<const float*>(t);
      uint8_t* out = dst + cur * kSize;
#pragma unroll
      for (int q = 0; q < kColsPerLane; ++q) {
        const int j = lane + 32 * q;
        if (j < kSize) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < KX; ++k) {
            acc = __fadd_rn(acc, __fmul_rn(cols.w[q][k],
                                           tf[cols.x0[q] + k]));
          }
          // acc >= 0: rounded half to even, clipped to 255
          out[j] = static_cast<uint8_t>(min(__float2uint_rn(acc), 255u));
        }
      }
      __syncwarp();                        // t has been read
#pragma unroll
      for (int p = 0; p < kLaneWords; ++p) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc0[p][b] = acc1[p][b];
          acc1[p][b] = 0.0f;
        }
      }
      if (++cur < r1) {
        last = s.taps[0][cur].x + s.taps[0][cur].y - 1;
        ys0 = ys1;
        ys1 = cur + 1 < r1 ? s.ys[cur + 1] : H;
      }
    }
  }
}

}  // namespace warp84
