// What kernels K1 (blend_fwd.cu) and K2 (blend_bwd.cu) share: the
// constants, the thread-to-pixel map, the staging of the instance stream,
// the per-warp cull and the rounded decision path. K2 has to re-take every
// accept, reject and stop of K1 bit for bit; both include this file, so it
// does by construction.
//
// The tile: one CTA per tile. Each warp owns a fixed patch of the tile
// (8x4 pixels: 32 warps at tile 32, 8 at tile 16) and each lane one pixel
// of it. On an H100 both kernels are bound by the serial walk of the
// longest tile on its SM, so a tile gets as many warps as a CTA can hold.
//
// The staging: the tile's range [start, end) of the row-major (K, 9) stream
// goes through a ring of two shared-memory batches as it lies in memory
// (36-byte rows): one thread asks the TMA for the next batch
// (`cp.async.bulk`, completing on an `mbarrier`) while the warps walk the
// current one; K1 stages 256 slots a batch, K2 128. Bulk copies need 16-byte addresses and sizes, and a row is
// aligned only every 4 slots, so the batches start at `start` rounded down
// to 4 slots (the head rows are masked) and the last batch's few odd floats
// are copied by the issuing thread.
//
// The cull: lane j of a warp tests slot j of each 32 slots of the batch
// against the warp's patch with the binning's exact ellipse-box test
// (ops/binning_dense.py::_box_qmin): the least q = d^T conic d over the
// patch's box against tau = 2 ln(255 opacity). The warp ballots and walks
// only the surviving slots, in stream order. A slot is culled only when
//   q_min > tau + kCullAbs + kCullRel * mag,
// mag the largest value the quadratic's terms take in the box, so float32
// rounding (of this test and of the decision path, both a few ulp of mag,
// and of logf/expf, ~1e-6) never culls a pair the decision path accepts:
// the accepted set, its order and every rounded operation stay what they
// are without the cull. Conics that are not positive on both axes, and
// NaNs, fall through to "not culled".
// ops/tile_blend.py::patch_cull_plain mirrors the test in PyTorch.
//
// `-DGA_COUNT=1` makes a counting build (cull tests, surviving warp-slots,
// pixel evaluations); it is not on any timed path.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GA_COUNT
#define GA_COUNT 0
#endif

namespace blend {

constexpr int kCols = 9;  // mx my | cxx cxy cyy | r g b | opacity
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kCullAbs = 1e-4f;
constexpr float kCullRel = 1e-5f;
constexpr int kPatchW = 8;  // a warp's patch of the tile, a pixel a lane
constexpr int kPatchH = 4;
constexpr int kStages = 2;  // staging buffers: one walked, one in flight
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// The thread-to-pixel map
// ---------------------------------------------------------------------------

template <int TILE>
struct Map {
  static_assert(TILE == 16 || TILE == 32, "tile 16 or 32");
  static_assert(kPatchW * kPatchH == 32, "a pixel a lane");
  static constexpr int kWarps = TILE * TILE / 32;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kPatchesX = TILE / kPatchW;

  int x, y;            // the lane's pixel
  float x_lo, x_hi;    // the warp's patch box, pixel centres, inclusive
  float y_lo, y_hi;    // (y with the slab's row offset)

  __device__ Map(int tile, int ntx, int py_offset) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int patch_x = (tile % ntx) * TILE + (warp % kPatchesX) * kPatchW;
    const int patch_y = (tile / ntx) * TILE + (warp / kPatchesX) * kPatchH;
    x = patch_x + lane % kPatchW;
    y = patch_y + lane / kPatchW;
    x_lo = static_cast<float>(patch_x);
    x_hi = static_cast<float>(patch_x + kPatchW - 1);
    y_lo = static_cast<float>(patch_y + py_offset);
    y_hi = static_cast<float>(patch_y + py_offset + kPatchH - 1);
  }
};

// ---------------------------------------------------------------------------
// The cull
// ---------------------------------------------------------------------------

struct Instance {
  float mx, my, cxx, cxy, cyy, r, g, b, op;
  __device__ __forceinline__ explicit Instance(const float* row)
      : mx(row[0]), my(row[1]), cxx(row[2]), cxy(row[3]), cyy(row[4]),
        r(row[5]), g(row[6]), b(row[7]), op(row[8]) {}
};

// True when no pixel of the box [x_lo, x_hi] x [y_lo, y_hi] can be accepted
// by the decision path for the instance `s`.
__device__ __forceinline__ bool patch_culled(const Instance& s, float x_lo,
                                             float x_hi, float y_lo,
                                             float y_hi) {
  const float mx = s.mx, my = s.my;
  const float cxx = s.cxx, cxy = s.cxy, cyy = s.cyy, op = s.op;
  const float ax = x_lo - mx, bx = x_hi - mx;
  const float ay = y_lo - my, by = y_hi - my;
  const float tau = 2.f * logf(255.f * op);
  const float ex = fmaxf(fabsf(ax), fabsf(bx));
  const float ey = fmaxf(fabsf(ay), fabsf(by));
  const float mag = cxx * ex * ex + cyy * ey * ey + 2.f * fabsf(cxy) * ex * ey;
  const float limit = tau + kCullAbs + kCullRel * mag;
  // the unconstrained argmin slopes of the clamped 1-D quadratics
  const float rx = -cxy / fmaxf(cyy, 1e-12f);
  const float ry = -cxy / fmaxf(cxx, 1e-12f);
  auto edge_x = [&](float e) {
    const float ystar = fminf(fmaxf(rx * e, ay), by);
    return (cxx * e + 2.f * cxy * ystar) * e + cyy * ystar * ystar;
  };
  auto edge_y = [&](float e) {
    const float xstar = fminf(fmaxf(ry * e, ax), bx);
    return (cyy * e + 2.f * cxy * xstar) * e + cxx * xstar * xstar;
  };
  float qmin = fminf(fminf(edge_x(ax), edge_x(bx)),
                     fminf(edge_y(ay), edge_y(by)));
  if (ax <= 0.f && bx >= 0.f && ay <= 0.f && by >= 0.f) qmin = 0.f;
  // fminf drops a NaN operand, so NaNs are sent to "not culled" by hand
  const float sum = mx + my + cxx + cxy + cyy;
  return cxx > 0.f && cyy > 0.f && sum == sum && qmin > limit;
}

// ---------------------------------------------------------------------------
// The rounded decision path
// ---------------------------------------------------------------------------

// One pixel against one instance, the part that needs no transmittance.
// Every operation is explicitly rounded (no FMA contraction), in the plain
// version's order, so every accept, reject and stop rounds as there and
// alike in K1 and K2. No branches: the lanes of a warp do not diverge
// before the verdict.
struct Footprint {
  float dx, dy, ex, e, alpha, one_minus;
  bool hit;  // power <= 0 and e >= 1/255: accepted unless the pixel stops

  __device__ __forceinline__ Footprint() {}
  __device__ __forceinline__ Footprint(const Instance& s, float px,
                                       float py) {
    dx = __fsub_rn(s.mx, px);
    dy = __fsub_rn(s.my, py);
    const float qxx = __fmul_rn(__fmul_rn(s.cxx, dx), dx);
    const float qyy = __fmul_rn(__fmul_rn(s.cyy, dy), dy);
    const float qxy = __fmul_rn(__fmul_rn(s.cxy, dx), dy);
    const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qxx, qyy)), qxy);
    ex = expf(power);
    e = __fmul_rn(s.op, ex);
    alpha = fminf(kAlphaMax, e);
    one_minus = __fsub_rn(1.f, alpha);
    hit = !(power > 0.f) && !(e < kAlphaMin);
  }
};

enum Verdict { kReject, kBlend, kStop };

// The pixel's verdict on an instance, with transmittance t before it;
// `test_t` is the transmittance after it where it blends.
__device__ __forceinline__ Verdict decide(const Footprint& f, float t,
                                          float& test_t) {
  if (!f.hit) return kReject;
  test_t = __fmul_rn(t, f.one_minus);
  return test_t < kTEps ? kStop : kBlend;
}

#if GA_COUNT
// cull tests made, warp-slots that survived, pixel evaluations made
__device__ unsigned long long g_counts[3];

struct Counter {
  unsigned long long n[3] = {0, 0, 0};
  __device__ void add(int what, unsigned long long v = 1) { n[what] += v; }
  __device__ ~Counter() {
    for (int i = 0; i < 3; ++i)
      if (n[i]) atomicAdd(&g_counts[i], n[i]);
  }
};
#else
struct Counter {
  __device__ void add(int, unsigned long long = 1) {}
};
#endif

// Calls body(k, instance, footprint) for every slot k in [head, n) of the
// staged rows that the cull keeps for this warp's patch, in stream order;
// `footprint` is the lane's pixel (px, py) against the instance. `done` is
// the lane's stop flag, which `body` may set; it is read once per 32
// slots: when every lane's pixel has stopped the warp leaves the batch.
template <int TILE, class Body>
__device__ __forceinline__ void walk_survivors(const float* rows, int head,
                                               int n, const Map<TILE>& map,
                                               float px, float py,
                                               const bool& done,
                                               Counter& counter,
                                               Body&& body) {
  const int lane = threadIdx.x % 32;
  for (int k0 = 0; k0 < n; k0 += 32) {
    if (__all_sync(kFull, done)) return;
    const int k = k0 + lane;
    bool keep = k >= head && k < n;
    if (keep) {
      counter.add(0);
      keep = !patch_culled(Instance(rows + k * kCols), map.x_lo, map.x_hi,
                           map.y_lo, map.y_hi);
    }
    unsigned survivors = __ballot_sync(kFull, keep);
    if (lane == 0) counter.add(1, __popc(survivors));
    while (survivors) {
      const int kk = k0 + __ffs(survivors) - 1;
      survivors &= survivors - 1;
      const Instance s(rows + kk * kCols);
      body(kk, s, Footprint(s, px, py));
    }
  }
}

// ---------------------------------------------------------------------------
// Staging the tile's range
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Batches of BATCH slots of [start, end) through a ring of kStages buffers.
// Use, by every thread of the CTA and in step:
//   Stager st(...); st.begin();
//   for b in 0 .. st.batches(): st.wait(b); <a CTA barrier>;
//                               st.prefetch(b); read st.rows(b)
// Leaving the loop after wait(b) and before prefetch(b) leaves no copy in
// flight.
template <int BATCH>
struct Stager {
  static_assert(BATCH % 32 == 0, "whole ballot words, 16-byte batches");
  static constexpr int kFloats = BATCH * kCols;

  float* ring;                 // [kStages][BATCH * kCols], 16-byte aligned
  unsigned long long* bars;    // [kStages]
  const float* inst;
  int first, start, end;

  __device__ Stager(float* ring, unsigned long long* bars, const float* inst,
                    int start, int end)
      : ring(ring), bars(bars), inst(inst), first(start & ~3), start(start),
        end(end) {}

  __device__ int batches() const { return (end - first + BATCH - 1) / BATCH; }
  __device__ int base(int b) const { return first + b * BATCH; }
  __device__ int count(int b) const { return min(BATCH, end - base(b)); }
  __device__ int head(int b) const { return b == 0 ? start - first : 0; }
  __device__ const float* rows(int b) const {
    return ring + (b % kStages) * kFloats;
  }

  __device__ void issue(int b) {   // one thread
    float* dst = ring + (b % kStages) * kFloats;
    const float* src = inst + static_cast<size_t>(base(b)) * kCols;
    const uint32_t bar = smem_addr(bars + b % kStages);
    const int floats = count(b) * kCols;
    const int bulk = floats & ~3;              // whole 16-byte pieces
    for (int i = bulk; i < floats; ++i) dst[i] = src[i];
    // the warps read this buffer's last batch through the generic proxy;
    // the CTA barrier ordered those reads before this thread, the fence
    // orders them before the TMA's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bulk * 4) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bulk * 4), "r"(bar)
        : "memory");
  }

  __device__ void begin() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                     :: "r"(smem_addr(bars + s)), "r"(1) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (batches() > 0) issue(0);
    }
    __syncthreads();
  }

  __device__ void wait(int b) {
    const uint32_t bar = smem_addr(bars + b % kStages);
    const uint32_t parity = (b / kStages) & 1;
    uint32_t ready = 0;
    while (!ready) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(ready) : "r"(bar), "r"(parity) : "memory");
    }
  }

  // after the CTA barrier that follows wait(b): the buffer of batch b - 1
  // is free, and takes batch b + 1
  __device__ void prefetch(int b) {
    if (threadIdx.x == 0 && b + 1 < batches()) issue(b + 1);
  }
};

}  // namespace blend
