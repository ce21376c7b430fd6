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
// What bounds it on an H100: as K1, the serial walk of the longest tile,
// not the card's float32 rate (the work is K1's plus ~40 operations per
// blended pair) and not bytes (the stream and its gradient, 36 B each per
// slot, and eight image planes: a few tens of MB). On top of K1's walk it
// pays the per-slot sums over the tile's pixels, and only one slot in five
// of a bound avatar's stream takes any gradient.
//
// What the design does about it (blend_common.cuh has the shared parts):
//   * K1's CTA (32 warps at tile 32), patches, pixel map, staging ring
//     (128-slot batches), per-warp cull and decision path, all from the
//     same header, so K2 accepts, rejects and stops where K1 did; one ulp
//     at a threshold would move the gradient by a term of size alpha T;
//   * per-slot sums without atomics: the dense binning gives every (tile,
//     Gaussian) pair its own slot, so a slot belongs to one CTA. A thread
//     has its pixel's 9 partials; only a warp that blended the slot
//     reduces them, by a transposing butterfly (16 shuffles: each step
//     halves the columns a lane holds), nine lanes write the warp's sums
//     to shared memory and the warp sets the slot's bit in its touched
//     mask. After the batch the CTA adds, per touched slot, the warps that
//     touched it in warp order and writes the slot once. The result is the
//     same bits from run to run;
//   * culled and untouched slots cost no shuffle, no shared store and no
//     global write: the wrapper zeroes the output, so they, the slots past
//     a tile's early stop and the slots no tile covers stay 0.

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int kBatch = 128;         // slots per staged batch
constexpr int kWords = kBatch / 32;  // touched-mask words per warp
constexpr int kBarBytes = 16 * ((kStages * 8 + 15) / 16);

template <int TILE>
constexpr size_t shared_bytes() {
  return kBarBytes + sizeof(float) * kStages * kBatch * kCols +
         sizeof(float) * Map<TILE>::kWarps * kBatch * kCols +
         sizeof(unsigned) * (Map<TILE>::kWarps + 2) * kWords;
}

// Sums each of the 9 columns over the warp's lanes. Padded to 16 columns,
// every step sends half of a lane's columns to its partner and keeps the
// partner's other half: 8 + 4 + 2 + 1 shuffles leave lane l with column
// (l >> 1) & 15 summed over 16 lanes, one more joins the pair.
__device__ __forceinline__ float reduce_columns(const float (&v)[kCols],
                                                int lane) {
  float p[16], a[8], b[4], c[2];
  const bool up16 = lane & 16, up8 = lane & 8, up4 = lane & 4, up2 = lane & 2;
#pragma unroll
  for (int j = 0; j < kCols; ++j) p[j] = v[j];
#pragma unroll
  for (int j = kCols; j < 16; ++j) p[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    a[j] = (up16 ? p[j + 8] : p[j]) +
           __shfl_xor_sync(kFull, up16 ? p[j] : p[j + 8], 16);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    b[j] = (up8 ? a[j + 4] : a[j]) +
           __shfl_xor_sync(kFull, up8 ? a[j] : a[j + 4], 8);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    c[j] = (up4 ? b[j + 2] : b[j]) +
           __shfl_xor_sync(kFull, up4 ? b[j] : b[j + 2], 4);
  const float d = (up2 ? c[1] : c[0]) +
                  __shfl_xor_sync(kFull, up2 ? c[0] : c[1], 2);
  return d + __shfl_xor_sync(kFull, d, 1);
}

template <int TILE>
__global__ void __launch_bounds__(Map<TILE>::kThreads)
blend_bwd_kernel(const float* __restrict__ inst, const int* __restrict__ ranges,
                 int ntx, int width, int height, int py_offset,
                 const float* __restrict__ color,
                 const float* __restrict__ trans,
                 const float* __restrict__ g_color,
                 const float* __restrict__ g_trans,
                 float* __restrict__ out_grad) {
  constexpr int kWarps = Map<TILE>::kWarps;
  constexpr int kThreads = Map<TILE>::kThreads;
  extern __shared__ __align__(16) unsigned char s_raw[];
  unsigned long long* s_bar = reinterpret_cast<unsigned long long*>(s_raw);
  float* s_ring = reinterpret_cast<float*>(s_raw + kBarBytes);
  float* s_part = s_ring + kStages * kBatch * kCols;  // [warp][slot][column]
  unsigned* s_touched =                               // [warp][word]
      reinterpret_cast<unsigned*>(s_part + kWarps * kBatch * kCols);
  // the warps' masks ORed, for batches of even and odd number in turn
  unsigned* s_union = s_touched + kWarps * kWords;    // [2][word]

  const int tile = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Map<TILE> map(tile, ntx, py_offset);
  const float px = static_cast<float>(map.x);
  const float py = static_cast<float>(map.y + py_offset);
  Counter counter;

  float t = 1.f, s_incl = 0.f, s_rest = 0.f, gr = 0.f, gg = 0.f, gb = 0.f;
  bool done = !(map.x < width && map.y < height);
  if (!done) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t idx = static_cast<size_t>(map.y) * width + map.x;
    gr = g_color[idx];
    gg = g_color[plane + idx];
    gb = g_color[2 * plane + idx];
    s_rest = gr * color[idx] + gg * color[plane + idx] +
             gb * color[2 * plane + idx] + g_trans[idx] * trans[idx];
  }

  Stager<kBatch> stage(s_ring, s_bar, inst, ranges[2 * tile],
                       ranges[2 * tile + 1]);
  const int batches = stage.batches();
  if (threadIdx.x < 2 * kWords) s_union[threadIdx.x] = 0u;
  if (batches > 0) stage.begin();
  for (int b = 0; b < batches; ++b) {
    stage.wait(b);
    // a barrier too: every warp has left batch b - 1 and its slots are
    // written out, so its buffer, the partials and the masks are free
    if (__syncthreads_count(done) == kThreads) break;
    stage.prefetch(b);
    // batch b - 1's union was read before that barrier; batch b + 1 takes it
    unsigned* any_touched = s_union + (b & 1) * kWords;
    if (threadIdx.x < kWords)
      s_union[((b + 1) & 1) * kWords + threadIdx.x] = 0u;

    float* part = s_part + warp * kBatch * kCols;
    unsigned* touched_words = s_touched + warp * kWords;
    if (lane < kWords) touched_words[lane] = 0u;
    __syncwarp();
    walk_survivors<TILE>(
        stage.rows(b), stage.head(b), stage.count(b), map, px, py, done,
        counter, [&](int k, const Instance& s, const Footprint& d) {
          float acc[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
          bool touched = false;
          if (!done) {
            counter.add(2);
            float test_t;
            const Verdict verdict = decide(d, t, test_t);
            if (verdict == kStop) done = true;
            if (verdict == kBlend) {
              const float w = __fmul_rn(d.alpha, t);
              const float cg = s.r * gr + s.g * gg + s.b * gb;
              s_incl += cg * w;
              acc[5] += gr * w;
              acc[6] += gg * w;
              acc[7] += gb * w;
              if (d.e < kAlphaMax) {
                const float d_alpha =
                    cg * t - (s_rest - s_incl) / d.one_minus;
                const float d_power = d_alpha * d.alpha;
                acc[0] -= d_power * (s.cxx * d.dx + s.cxy * d.dy);
                acc[1] -= d_power * (s.cyy * d.dy + s.cxy * d.dx);
                acc[2] -= d_power * (0.5f * d.dx * d.dx);
                acc[3] -= d_power * (d.dx * d.dy);
                acc[4] -= d_power * (0.5f * d.dy * d.dy);
                acc[8] += d_alpha * d.ex;
              }
              t = test_t;
              touched = true;
            }
          }
          if (!__any_sync(kFull, touched)) return;
          const float sum = reduce_columns(acc, lane);
          const int column = lane >> 1;
          if ((lane & 1) == 0 && column < kCols)
            part[k * kCols + column] = sum;
          // one lane owns the warp's mask words; the union is an OR, which
          // gives the same bits in any order
          if (lane == 0) {
            touched_words[k >> 5] |= 1u << (k & 31);
            atomicOr(&any_touched[k >> 5], 1u << (k & 31));
          }
        });
    __syncthreads();

    // one write per touched slot, the warps that touched it added in warp
    // order; a thread takes three columns of a slot
    const int head = stage.head(b), n = stage.count(b);
    float* dst = out_grad + static_cast<size_t>(stage.base(b)) * kCols;
    for (int item = threadIdx.x; item < 3 * kBatch; item += kThreads) {
      const int k = item % kBatch, c0 = 3 * (item / kBatch);
      if (k < head || k >= n) continue;
      if (!((any_touched[k >> 5] >> (k & 31)) & 1u)) continue;
      unsigned who = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        who |= ((s_touched[w * kWords + (k >> 5)] >> (k & 31)) & 1u) << w;
      float sum[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (!((who >> w) & 1u)) continue;
        const float* src = s_part + (w * kBatch + k) * kCols + c0;
        sum[0] += src[0];
        sum[1] += src[1];
        sum[2] += src[2];
      }
      dst[k * kCols + c0] = sum[0];
      dst[k * kCols + c0 + 1] = sum[1];
      dst[k * kCols + c0 + 2] = sum[2];
    }
  }
}

template <int TILE>
cudaError_t launch(const float* inst, const int* ranges, int num_tiles,
                   int ntx, int width, int height, int py_offset,
                   const float* color, const float* trans,
                   const float* g_color, const float* g_trans,
                   float* out_grad, cudaStream_t s) {
  constexpr size_t kShared = shared_bytes<TILE>();
  // above 48 KB shared memory is opt-in, per device: asked at every launch
  const cudaError_t err = cudaFuncSetAttribute(
      blend_bwd_kernel<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kShared));
  if (err != cudaSuccess) return err;
  blend_bwd_kernel<TILE><<<num_tiles, Map<TILE>::kThreads, kShared, s>>>(
      inst, ranges, ntx, width, height, py_offset, color, trans, g_color,
      g_trans, out_grad);
  return cudaGetLastError();
}

}  // namespace

// inst: (K, 9) float32 row-major stream, 16-byte aligned; ranges:
// (num_tiles, 2) int32 [start, end) per tile, tiles row-major over an
// ntx-wide grid; color and g_color: (3, height, width) float32; trans and
// g_trans: (height, width) float32; out_grad: (K, 9) float32, zeroed by the
// caller; py_offset: global pixel row of the slab's first row. Launches on
// `stream` and returns the CUDA error (0 on success).
extern "C" int blend_bwd(const float* inst, const int* ranges, int num_tiles,
                         int ntx, int width, int height, int tile_size,
                         int py_offset, const float* color, const float* trans,
                         const float* g_color, const float* g_trans,
                         float* out_grad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  if (tile_size == 16)
    return static_cast<int>(launch<16>(
        inst, ranges, num_tiles, ntx, width, height, py_offset, color, trans,
        g_color, g_trans, out_grad, s));
  if (tile_size == 32)
    return static_cast<int>(launch<32>(
        inst, ranges, num_tiles, ntx, width, height, py_offset, color, trans,
        g_color, g_trans, out_grad, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[4]: registers per thread, shared memory per CTA in bytes, CTAs
// resident per SM and local memory per thread in bytes of the kernel for
// `tile_size`, as the runtime reports them.
extern "C" int blend_bwd_residency(int tile_size, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (tile_size == 16) {
    out[1] = static_cast<int>(shared_bytes<16>());
    err = cudaFuncGetAttributes(&attr, blend_bwd_kernel<16>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[2], blend_bwd_kernel<16>, Map<16>::kThreads, out[1]);
  } else {
    out[1] = static_cast<int>(shared_bytes<32>());
    err = cudaFuncGetAttributes(&attr, blend_bwd_kernel<32>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[2], blend_bwd_kernel<32>, Map<32>::kThreads, out[1]);
  }
  out[0] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[1] += static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(err);
}

#if GA_COUNT
// Copies the counters (cull tests, surviving warp-slots, pixel
// evaluations) to `out` and sets them to 0; waits for the device.
extern "C" int blend_bwd_counts(unsigned long long* out) {
  const unsigned long long zero[3] = {0, 0, 0};
  cudaError_t err = cudaMemcpyFromSymbol(out, blend::g_counts, sizeof(zero));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(blend::g_counts, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
