// Kernel K1: forward front-to-back alpha blend of the tile-major,
// depth-sorted instance stream into an image.
//
// Replaces gaussianavatars_tpu/ops/blend_pallas.py::blend_image_fwd_pallas
// (the Pallas `_fwd_kernel`). Semantics follow the blueprint
// gaussianavatars_tpu/ops/tile_blend.py::_blend_tile_fwd; the plain PyTorch
// version beside this kernel is
// gaussianavatars_torch/ops/tile_blend.py::blend_image_plain.
//
// Per pixel (x, y + py_offset), per instance of its tile's range
// [start, end) in depth order:
//   power = -1/2 (cxx dx^2 + cyy dy^2) - cxy dx dy, d = mean2d - pixel
//   skip if power > 0 or e = opacity * exp(power) < 1/255
//   alpha = min(0.99, e); stop (pixel done) before the instance that would
//   take T below 1e-4; else color += c * alpha * T, T *= 1 - alpha.
// Outputs: color [3, H, W] without background and the final T [H, W].
//
// What bounds it on an H100: arithmetic, not bytes. The stream is read
// once per tile (36 B per instance) and each pixel written once, a few
// tens of MB at the bench shape, while the work is one quadratic (~11 FP32
// operations) for every evaluated pixel-instance pair, one expf (MUFU.EX2
// on the SFU, which issues at 1/8 the FP32 rate) for every pair with
// power <= 0, and ~10 more operations for every accepted pair: roughly
// K x P pairs less the early-out, K ~ 0.7M instances and P = 1024 pixels.
//
// Design (the reference CUDA rasterizer's, SURVEY.md 2.4 N1):
//   * one 256-thread CTA per tile; at tile 32 each thread owns 4 adjacent
//     pixels of one row, so a warp covers a 32x4 patch. Each instance read
//     from shared memory then feeds 4 pixel evaluations (a 1024-thread CTA
//     would reload it per pixel and cap residency at two CTAs per SM);
//   * the threads load batches of 256 instances of the tile's range into
//     shared memory as SoA, then every thread walks the batch in order;
//   * `__syncthreads_count` on the per-thread done flags ends the tile
//     once every pixel has saturated (T would drop below 1e-4);
//   * pixels past the ragged right and bottom image edges start done and
//     are never written (802 is not a multiple of 32).
// The quadratic and the accept tests use explicitly rounded operations
// (no FMA contraction), so every accept/reject decision at power <= 0 and
// e >= 1/255 rounds exactly as in the plain version; only the color sums
// use FMA. Making it fast (warp-level culling, tile 16, deeper batching)
// is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 9;  // mx my | cxx cxy cyy | r g b | opacity
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

template <int TILE>
__global__ void __launch_bounds__(kThreads)
blend_fwd_kernel(const float* __restrict__ inst, const int* __restrict__ ranges,
                 int ntx, int width, int height, int py_offset,
                 float* __restrict__ color, float* __restrict__ trans) {
  constexpr int kPix = TILE * TILE / kThreads;  // pixels per thread
  __shared__ float s_inst[kCols][kThreads];

  const int tile = blockIdx.x;
  const int x0 = (tile % ntx) * TILE;
  const int y0 = (tile / ntx) * TILE;
  const int start = ranges[2 * tile];
  const int end = ranges[2 * tile + 1];

  int xs[kPix], ys[kPix];
  float px[kPix], py[kPix], t[kPix], cr[kPix], cg[kPix], cb[kPix];
  bool done[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = threadIdx.x * kPix + i;
    xs[i] = x0 + p % TILE;
    ys[i] = y0 + p / TILE;
    px[i] = static_cast<float>(xs[i]);
    py[i] = static_cast<float>(ys[i] + py_offset);
    t[i] = 1.f;
    cr[i] = cg[i] = cb[i] = 0.f;
    done[i] = !(xs[i] < width && ys[i] < height);
  }

  for (int base = start; base < end; base += kThreads) {
    bool thread_done = true;
#pragma unroll
    for (int i = 0; i < kPix; ++i) thread_done = thread_done && done[i];
    // a barrier too: the previous batch is consumed before it is replaced
    if (__syncthreads_count(thread_done) == kThreads) break;

    const int j = base + threadIdx.x;
    if (j < end) {
      const float* row = inst + static_cast<size_t>(j) * kCols;
#pragma unroll
      for (int c = 0; c < kCols; ++c) s_inst[c][threadIdx.x] = row[c];
    }
    __syncthreads();

    const int n = min(kThreads, end - base);
    for (int k = 0; k < n; ++k) {
      const float mx = s_inst[0][k], my = s_inst[1][k];
      const float cxx = s_inst[2][k], cxy = s_inst[3][k], cyy = s_inst[4][k];
      const float r = s_inst[5][k], g = s_inst[6][k], b = s_inst[7][k];
      const float op = s_inst[8][k];
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        if (done[i]) continue;
        const float dx = __fsub_rn(mx, px[i]);
        const float dy = __fsub_rn(my, py[i]);
        const float qxx = __fmul_rn(__fmul_rn(cxx, dx), dx);
        const float qyy = __fmul_rn(__fmul_rn(cyy, dy), dy);
        const float qxy = __fmul_rn(__fmul_rn(cxy, dx), dy);
        const float power =
            __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qxx, qyy)), qxy);
        if (power > 0.f) continue;
        const float e = __fmul_rn(op, expf(power));
        if (e < kAlphaMin) continue;
        const float alpha = fminf(kAlphaMax, e);
        const float test_t = __fmul_rn(t[i], __fsub_rn(1.f, alpha));
        if (test_t < kTEps) {
          done[i] = true;
          continue;
        }
        const float w = __fmul_rn(alpha, t[i]);
        cr[i] = fmaf(r, w, cr[i]);
        cg[i] = fmaf(g, w, cg[i]);
        cb[i] = fmaf(b, w, cb[i]);
        t[i] = test_t;
      }
    }
  }

  const size_t plane = static_cast<size_t>(width) * height;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    if (xs[i] < width && ys[i] < height) {
      const size_t idx = static_cast<size_t>(ys[i]) * width + xs[i];
      color[idx] = cr[i];
      color[plane + idx] = cg[i];
      color[2 * plane + idx] = cb[i];
      trans[idx] = t[i];
    }
  }
}

}  // namespace

// inst: (K, 9) float32 row-major stream; ranges: (num_tiles, 2) int32
// [start, end) per tile, tiles row-major over an ntx-wide grid; color:
// (3, height, width) float32; trans: (height, width) float32; py_offset:
// global pixel row of the slab's first row. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int blend_fwd(const float* inst, const int* ranges, int num_tiles,
                         int ntx, int width, int height, int tile_size,
                         int py_offset, float* color, float* trans,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0) {
    if (tile_size == 16) {
      blend_fwd_kernel<16><<<num_tiles, kThreads, 0, s>>>(
          inst, ranges, ntx, width, height, py_offset, color, trans);
    } else if (tile_size == 32) {
      blend_fwd_kernel<32><<<num_tiles, kThreads, 0, s>>>(
          inst, ranges, ntx, width, height, py_offset, color, trans);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
