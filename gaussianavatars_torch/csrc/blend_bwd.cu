// Kernel K2: backward (VJP) of the front-to-back tile blend of kernel K1.
//
// Replaces gaussianavatars_tpu/ops/blend_pallas.py::blend_image_bwd_pallas
// (:763, the Pallas `_bwd_kernel` / `_bwd_tile`). Semantics follow the
// blueprint gaussianavatars_tpu/ops/tile_blend.py::_blend_tile_bwd; the
// plain PyTorch version beside this kernel is
// gaussianavatars_torch/ops/tile_blend.py::blend_image_bwd_plain.
//
// Inputs: the (K, 9) stream and per-tile [start, end) ranges that K1
// blended, K1's color [3, H, W] and T [H, W], and their cotangents G and
// g_T. Output: one (K, 9) gradient row per stream slot, in the stream's
// column layout (mean2d 2 | conic 3 | color 3 | opacity 1).
//
// Each pixel walks its tile's range front to back again, re-deciding every
// accept, reject and stop exactly as K1 did, and carries T and the
// inclusive prefix S_incl of (c . G) w. It starts from
// S_rest = G . C_out + g_T T_out, so the suffix the gradient needs is
// S_rest - S_incl (the blueprint's forward-order form: no back-to-front
// walk, no T rebuilt by dividing by 1 - alpha). For a blended instance
//   w       = alpha T_before               d_color = G w
//   d_alpha = (c . G) T_before - (S_rest - S_incl) / (1 - alpha)
// and, where the 0.99 clamp is not active (else those three are zero),
//   d_opacity = d_alpha exp(power)
//   d_power   = d_alpha alpha,  d_mean = d_power dpower/dmean,
//                               d_conic = d_power dpower/dconic.
// Rejected instances and those after the pixel stopped contribute zero.
//
// What bounds it on an H100: arithmetic, as for K1. Bytes are the stream
// and its gradient (36 B each per slot) and eight image planes, a few tens
// of MB; the work is the forward's quadratic for every walked pixel-slot
// pair, one expf for each with power <= 0, and ~40 more FP32 operations for
// every blended pair, plus the per-slot reduction over the tile's pixels.
//
// Design:
//   * one 256-thread CTA per tile and the same thread-to-pixel map as K1 (4
//     adjacent pixels of one row at tile 32, 1 pixel at tile 16); each CTA
//     reads its own [start, end) and loads batches of 128 slots into shared
//     memory;
//   * the decision path (quadratic, e, alpha, the T update) uses K1's
//     explicitly rounded operations in K1's order, so K2 accepts, rejects
//     and stops where K1 did; one ulp at a threshold would move the
//     gradient by a term of size alpha T;
//   * per-slot sums without global atomics: the dense binning gives every
//     (tile, Gaussian) pair its own slot, so a slot belongs to one tile.
//     Each thread sums its pixels' 9 partials, a warp reduces them with an
//     xor butterfly (skipped when no lane of the warp blended the slot),
//     lane 0 writes the warp's sums to shared memory, and after the batch
//     the CTA adds the 8 warps' sums in a fixed order and writes each slot
//     once. The result is the same from run to run;
//   * the wrapper zeroes the output, so slots past a tile's early stop and
//     slots no tile covers stay 0; `__syncthreads_count` on the done flags
//     ends the tile once every pixel has stopped, and a warp whose pixels
//     have all stopped skips the rest of the batch.
// Making it fast (warp-level culling, fusing the per-Gaussian reduction of
// the stream gather's transpose) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 128;  // slots staged in shared memory at a time
constexpr int kCols = 9;     // mx my | cxx cxy cyy | r g b | opacity
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

template <int TILE>
__global__ void __launch_bounds__(kThreads)
blend_bwd_kernel(const float* __restrict__ inst, const int* __restrict__ ranges,
                 int ntx, int width, int height, int py_offset,
                 const float* __restrict__ color,
                 const float* __restrict__ trans,
                 const float* __restrict__ g_color,
                 const float* __restrict__ g_trans,
                 float* __restrict__ out_grad) {
  constexpr int kPix = TILE * TILE / kThreads;  // pixels per thread
  __shared__ float s_inst[kCols][kBatch];
  __shared__ float s_part[kWarps][kBatch][kCols];

  const int tile = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int x0 = (tile % ntx) * TILE;
  const int y0 = (tile / ntx) * TILE;
  const int start = ranges[2 * tile];
  const int end = ranges[2 * tile + 1];
  const size_t plane = static_cast<size_t>(width) * height;

  float px[kPix], py[kPix], t[kPix], s_incl[kPix], s_rest[kPix];
  float gr[kPix], gg[kPix], gb[kPix];
  bool done[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = threadIdx.x * kPix + i;
    const int x = x0 + p % TILE;
    const int y = y0 + p / TILE;
    px[i] = static_cast<float>(x);
    py[i] = static_cast<float>(y + py_offset);
    t[i] = 1.f;
    s_incl[i] = 0.f;
    done[i] = !(x < width && y < height);
    gr[i] = gg[i] = gb[i] = s_rest[i] = 0.f;
    if (!done[i]) {
      const size_t idx = static_cast<size_t>(y) * width + x;
      gr[i] = g_color[idx];
      gg[i] = g_color[plane + idx];
      gb[i] = g_color[2 * plane + idx];
      s_rest[i] = gr[i] * color[idx] + gg[i] * color[plane + idx] +
                  gb[i] * color[2 * plane + idx] + g_trans[idx] * trans[idx];
    }
  }

  for (int base = start; base < end; base += kBatch) {
    bool thread_done = true;
#pragma unroll
    for (int i = 0; i < kPix; ++i) thread_done = thread_done && done[i];
    // a barrier too: the previous batch's slots are written out and its
    // shared memory free before it is replaced
    if (__syncthreads_count(thread_done) == kThreads) break;

    const int n = min(kBatch, end - base);
    if (threadIdx.x < n) {
      const float* row = inst + static_cast<size_t>(base + threadIdx.x) * kCols;
#pragma unroll
      for (int c = 0; c < kCols; ++c) s_inst[c][threadIdx.x] = row[c];
    }
    __syncthreads();

    int k = 0;
    for (; k < n; ++k) {
      bool all_done = true;
#pragma unroll
      for (int i = 0; i < kPix; ++i) all_done = all_done && done[i];
      if (__all_sync(kFull, all_done)) break;

      const float mx = s_inst[0][k], my = s_inst[1][k];
      const float cxx = s_inst[2][k], cxy = s_inst[3][k], cyy = s_inst[4][k];
      const float r = s_inst[5][k], g = s_inst[6][k], b = s_inst[7][k];
      const float op = s_inst[8][k];
      float acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
      bool touched = false;
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        if (done[i]) continue;
        // decision path: K1's operations in K1's order
        const float dx = __fsub_rn(mx, px[i]);
        const float dy = __fsub_rn(my, py[i]);
        const float qxx = __fmul_rn(__fmul_rn(cxx, dx), dx);
        const float qyy = __fmul_rn(__fmul_rn(cyy, dy), dy);
        const float qxy = __fmul_rn(__fmul_rn(cxy, dx), dy);
        const float power =
            __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qxx, qyy)), qxy);
        if (power > 0.f) continue;
        const float ex = expf(power);
        const float e = __fmul_rn(op, ex);
        if (e < kAlphaMin) continue;
        const float alpha = fminf(kAlphaMax, e);
        const float one_minus = __fsub_rn(1.f, alpha);
        const float test_t = __fmul_rn(t[i], one_minus);
        if (test_t < kTEps) {
          done[i] = true;
          continue;
        }
        const float w = __fmul_rn(alpha, t[i]);
        // gradient path
        const float cg = r * gr[i] + g * gg[i] + b * gb[i];
        s_incl[i] += cg * w;
        acc[5] += gr[i] * w;
        acc[6] += gg[i] * w;
        acc[7] += gb[i] * w;
        if (e < kAlphaMax) {
          const float d_alpha = cg * t[i] - (s_rest[i] - s_incl[i]) / one_minus;
          const float d_power = d_alpha * alpha;
          acc[0] -= d_power * (cxx * dx + cxy * dy);
          acc[1] -= d_power * (cyy * dy + cxy * dx);
          acc[2] -= d_power * (0.5f * dx * dx);
          acc[3] -= d_power * (dx * dy);
          acc[4] -= d_power * (0.5f * dy * dy);
          acc[8] += d_alpha * ex;
        }
        t[i] = test_t;
        touched = true;
      }
      if (__any_sync(kFull, touched)) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[c] += __shfl_xor_sync(kFull, acc[c], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) s_part[warp][k][c] = acc[c];
      }
    }
    // this warp's pixels all stopped: it adds nothing to the rest
    for (int kk = k + lane; kk < n; kk += 32) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) s_part[warp][kk][c] = 0.f;
    }
    __syncthreads();

    // one write per slot column, the warps summed in a fixed order
    float* dst = out_grad + static_cast<size_t>(base) * kCols;
    for (int idx = threadIdx.x; idx < n * kCols; idx += kThreads) {
      const int kk = idx / kCols, c = idx % kCols;
      float sum = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) sum += s_part[wi][kk][c];
      dst[idx] = sum;
    }
  }
}

}  // namespace

// inst: (K, 9) float32 row-major stream; ranges: (num_tiles, 2) int32
// [start, end) per tile, tiles row-major over an ntx-wide grid; color and
// g_color: (3, height, width) float32; trans and g_trans: (height, width)
// float32; out_grad: (K, 9) float32, zeroed by the caller; py_offset:
// global pixel row of the slab's first row. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int blend_bwd(const float* inst, const int* ranges, int num_tiles,
                         int ntx, int width, int height, int tile_size,
                         int py_offset, const float* color, const float* trans,
                         const float* g_color, const float* g_trans,
                         float* out_grad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0) {
    if (tile_size == 16) {
      blend_bwd_kernel<16><<<num_tiles, kThreads, 0, s>>>(
          inst, ranges, ntx, width, height, py_offset, color, trans, g_color,
          g_trans, out_grad);
    } else if (tile_size == 32) {
      blend_bwd_kernel<32><<<num_tiles, kThreads, 0, s>>>(
          inst, ranges, ntx, width, height, py_offset, color, trans, g_color,
          g_trans, out_grad);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
