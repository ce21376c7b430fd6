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
// What bounds it on an H100: operations, not bytes, and among the
// operations not their number but their order. The stream is read once per
// tile (36 B per instance) and each pixel written once, a few tens of MB.
// The arithmetic the pixels need (a quadratic per pixel-instance pair
// before the pixel stops, an expf and ~10 more operations per accepted
// pair) is tens of microseconds of the card's float32 rate. What takes
// the time is the serial walk of the longest tile: a pixel's T depends on
// every instance before it, a bound avatar's Gaussians are a few pixels
// wide so a 32x32 tile accepts each in a small corner only, and the head
// fills a few hundred middle tiles while the border tiles are empty.
//
// What the design does about it (blend_common.cuh has the shared parts):
//   * one CTA per tile and one warp per 8x4 patch of it, a pixel a lane:
//     1024 threads at tile 32, so the longest tile's walk is spread over
//     every warp slot of its SM (256 threads with 4 pixels each left the
//     SM that holds it waiting on two warps a scheduler);
//   * exact culling per warp: lane j tests slot j of every 32 staged slots
//     against the warp's patch with the binning's ellipse-box test, the
//     warp ballots and walks only the survivors, in stream order. The test
//     is widened by a stated margin so that it never drops a pair the
//     decision path accepts: the image is bit for bit the one without it;
//   * the range is staged through a two-buffer ring of 256-slot batches by
//     TMA bulk copies that complete on an mbarrier: the next batch loads
//     while this one is walked, and the CTA meets at one barrier per batch;
//   * that barrier counts the done flags (`__syncthreads_count`) and ends
//     the tile once every pixel has saturated; a warp whose pixels have all
//     stopped leaves the batch at once;
//   * pixels past the ragged right and bottom image edges start done and
//     are never written (802 is not a multiple of 32);
//   * the quadratic and the accept tests use explicitly rounded operations
//     (no FMA contraction), so every decision rounds exactly as in the
//     plain version; only the color sums use FMA.
// Tensor cores have no place here: the only product is the 6-term
// quadratic, whose accept/reject decisions at the 1/255 and 1e-4 thresholds
// need float32 (TF32 keeps 10 mantissa bits), and after the cull the
// float32 pipe has little left to do.

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int kBatch = 256;  // slots per staged batch

template <int TILE>
__global__ void __launch_bounds__(Map<TILE>::kThreads)
blend_fwd_kernel(const float* __restrict__ inst, const int* __restrict__ ranges,
                 int ntx, int width, int height, int py_offset,
                 float* __restrict__ color, float* __restrict__ trans) {
  constexpr int kThreads = Map<TILE>::kThreads;
  __shared__ __align__(16) float s_ring[kStages * kBatch * kCols];
  __shared__ __align__(8) unsigned long long s_bar[kStages];

  const int tile = blockIdx.x;
  const Map<TILE> map(tile, ntx, py_offset);
  const float px = static_cast<float>(map.x);
  const float py = static_cast<float>(map.y + py_offset);
  const bool inside = map.x < width && map.y < height;
  Counter counter;

  float t = 1.f, cr = 0.f, cg = 0.f, cb = 0.f;
  bool done = !inside;

  Stager<kBatch> stage(s_ring, s_bar, inst, ranges[2 * tile],
                       ranges[2 * tile + 1]);
  const int batches = stage.batches();
  if (batches > 0) stage.begin();
  for (int b = 0; b < batches; ++b) {
    stage.wait(b);
    // a barrier too: every warp has left batch b - 1, so its buffer is free
    if (__syncthreads_count(done) == kThreads) break;
    stage.prefetch(b);
    walk_survivors<TILE>(
        stage.rows(b), stage.head(b), stage.count(b), map, px, py, done,
        counter, [&](int, const Instance& s, const Footprint& f) {
          if (done) return;
          counter.add(2);
          float test_t;
          const Verdict verdict = decide(f, t, test_t);
          if (verdict == kStop) done = true;
          if (verdict != kBlend) return;
          const float w = __fmul_rn(f.alpha, t);
          cr = fmaf(s.r, w, cr);
          cg = fmaf(s.g, w, cg);
          cb = fmaf(s.b, w, cb);
          t = test_t;
        });
  }

  if (inside) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t idx = static_cast<size_t>(map.y) * width + map.x;
    color[idx] = cr;
    color[plane + idx] = cg;
    color[2 * plane + idx] = cb;
    trans[idx] = t;
  }
}

template <int TILE>
void launch(const float* inst, const int* ranges, int num_tiles, int ntx,
            int width, int height, int py_offset, float* color, float* trans,
            cudaStream_t s) {
  blend_fwd_kernel<TILE><<<num_tiles, Map<TILE>::kThreads, 0, s>>>(
      inst, ranges, ntx, width, height, py_offset, color, trans);
}

}  // namespace

// inst: (K, 9) float32 row-major stream, 16-byte aligned; ranges:
// (num_tiles, 2) int32 [start, end) per tile, tiles row-major over an
// ntx-wide grid; color: (3, height, width) float32; trans: (height, width)
// float32; py_offset: global pixel row of the slab's first row. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int blend_fwd(const float* inst, const int* ranges, int num_tiles,
                         int ntx, int width, int height, int tile_size,
                         int py_offset, float* color, float* trans,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0) {
    if (tile_size == 16) {
      launch<16>(inst, ranges, num_tiles, ntx, width, height, py_offset,
                 color, trans, s);
    } else if (tile_size == 32) {
      launch<32>(inst, ranges, num_tiles, ntx, width, height, py_offset,
                 color, trans, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out[4]: registers per thread, shared memory per CTA in bytes, CTAs
// resident per SM and local memory per thread in bytes of the kernel for
// `tile_size`, as the runtime reports them.
extern "C" int blend_fwd_residency(int tile_size, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (tile_size == 16) {
    err = cudaFuncGetAttributes(&attr, blend_fwd_kernel<16>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[2], blend_fwd_kernel<16>, Map<16>::kThreads, 0);
  } else {
    err = cudaFuncGetAttributes(&attr, blend_fwd_kernel<32>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[2], blend_fwd_kernel<32>, Map<32>::kThreads, 0);
  }
  out[0] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(err);
}

#if GA_COUNT
// Copies the counters (cull tests, surviving warp-slots, pixel
// evaluations) to `out` and sets them to 0; waits for the device.
extern "C" int blend_fwd_counts(unsigned long long* out) {
  const unsigned long long zero[3] = {0, 0, 0};
  cudaError_t err = cudaMemcpyFromSymbol(out, blend::g_counts, sizeof(zero));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(blend::g_counts, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
