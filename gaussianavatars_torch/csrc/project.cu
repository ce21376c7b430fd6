// Kernels project_fwd and project_bwd: the screen-space projection of 3D
// Gaussians with their SH colours, and its VJP, one thread a Gaussian.
//
// They replace no TPU kernel: the JAX package leaves
// gaussianavatars_tpu/ops/projection.py::project_gaussians to XLA, which
// fuses it. The port's plain version
// (gaussianavatars_torch/ops/projection.py::project_gaussians_plain and,
// for the backward, project_bwd_plain, which this file mirrors line by
// line) runs as ~450 elementwise launches forward and ~650 in autograd's
// backward, each a pass over every Gaussian.
//
// Forward, per Gaussian (the plain version's semantics, float32):
//   p_view = [p, 1] @ V, culled when z <= 0.2; p_hom = [p, 1] @ P;
//   means2d = ndc2pix(p_hom.xy / (w + 1e-7) + offset) (w = 1 when culled);
//   Sigma = R diag((m s)^2) R^T from the normalised quaternion;
//   cov2d = J W Sigma W^T J^T + 0.3 I with J at the view position clamped
//   to 1.3 tan(fov / 2) of the frustum and to z >= 0.2;
//   conic = cov2d^-1 where det > 0; radius, r2_max, tau and the per-axis
//   extents from lambda_max and the opacity's reach; valid = in front,
//   det > 0, radius > 0 and on screen;
//   color = max(sum_k basis_k(normalize(p - campos)) sh_ck + 0.5, 0).
// Backward: the VJP of means2d, conics and colors to means3d, scales,
// quats, shs and the offset, from the inputs alone (the forward's
// intermediates are recomputed); a gradient stops where the forward's
// clamp or select stops it. depths, radii, valid, r2_max, tau and the
// extents carry none.
//
// What bounds them on an H100: bytes. The forward reads 236 B a Gaussian
// at SH degree 3 (xyz, scales, quaternion, opacity, 48 SH floats) and
// writes 57; the backward reads the inputs again and 32 B of cotangents,
// and writes 240 B of gradients. A few hundred FP32 operations a Gaussian
// are far below the card's rate.
//
// What the design does about it:
//   * every intermediate stays in registers: one read of each input, one
//     write of each output, no temporaries in device memory;
//   * the SH rows, the widest input, are staged a block of 128 rows at a
//     time through shared memory by the whole block (neighbouring threads
//     on neighbouring addresses), then read by each thread from its own
//     row (an odd row stride, so the 32 rows a warp reads sit in 32
//     banks); the backward writes its SH gradient rows the same way back;
//   * only the (deg + 1)^2 coefficients a channel that the degree uses are
//     read; the backward writes zeros for the rest of each row;
//   * the cotangents are read in place through their row strides (the
//     pack's gradient hands them over as stride-9 column slices);
//   * the camera's matrices are read on the device (a block's threads
//     stage them once), so a launch reads no host copy of them and a CUDA
//     graph can capture it;
//   * the file is built without FMA contraction (kernels.SOURCE_FLAGS):
//     each operation rounds as the plain version's elementwise ops do, the
//     clip transform's dot products are FMA chains as its matrix product
//     rounds them, and |q|^2 is summed in its order, so most fields come
//     out as the plain version's bits. Conics of near-degenerate
//     Gaussians and pixel centres near the image's top and left edges
//     (ndc + 1 cancels) amplify what rounding is left. Memory bounds the
//     kernels, so the unfused operations cost no time.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNear = 0.2f;
constexpr float kDilation = 0.3f;
constexpr float kWEps = 1e-7f;
constexpr float kQuatEps = 1e-24f;
constexpr float kDirEps = 1e-12f;

constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
// uniform reads at compile-time indices: the constant cache broadcasts them
__constant__ float kC2[5] = {1.0925484305920792f, -1.0925484305920792f,
                            0.31539156525252005f, -1.0925484305920792f,
                            0.5462742152960396f};
__constant__ float kC3[7] = {-0.5900435899266435f, 2.890611442640554f,
                            -0.4570457994644658f, 0.3731763325901154f,
                            -0.4570457994644658f, 1.445305721320277f,
                            -0.5900435899266435f};
__constant__ float kC4[9] = {2.5033429417967046f, -1.7701307697799304f,
                            0.9461746957575601f, -0.6690465435572892f,
                            0.10578554691520431f, -0.6690465435572892f,
                            0.47308734787878004f, -1.7701307697799304f,
                            0.6258357354491761f};

__host__ __device__ constexpr int num_coeffs(int deg) {
  return (deg + 1) * (deg + 1);
}
// a staged SH row: 3 * (deg + 1)^2 floats, rounded up to an odd count
__host__ __device__ constexpr int row_floats(int deg) {
  return (3 * num_coeffs(deg)) | 1;
}

struct Camera {
  const float* vm;       // [4, 4] world->view, transposed storage
  const float* pm;       // [4, 4] world->clip, transposed storage
  const float* campos;   // [3]
  float limx, limy;      // 1.3 tan(fov / 2)
  float focal_x, focal_y;
  int width, height;
};

struct Args {
  int n;
  const float* means3d;  // [n, 3]
  const float* scales;   // [n, 3]
  const float* quats;    // [n, 4] wxyz
  const float* opac;     // [n] (forward)
  const float* shs;      // [n, 3K] channel-major, rows sh_stride apart;
                         // null: no colours
  long long sh_stride;
  int k;                 // coefficients a channel
  const float* offset;   // [n, 2] or null (forward)
  Camera cam;
  float smod;            // scaling_modifier
  // forward outputs
  float *means2d, *depths, *conics, *colors;
  int* radii;
  unsigned char* valid;
  float *r2_max, *ext_x, *ext_y, *tau;
  // backward: cotangents (null reads as zero) and their row strides
  const float *g_means2d, *g_conics, *g_colors;
  long long gs_means2d, gs_conics, gs_colors;
  // backward outputs
  float *d_means3d, *d_scales, *d_quats, *d_shs, *d_offset;
};

// The camera staged in shared memory: V (16), P (16), campos (3).
struct CamView {
  const float* v;
  const float* p;
  const float* c;
};

// The forward's intermediates of one Gaussian (`_clip`,
// `_rotation_scale`, `_cov3d_components` and `_ewa` of the plain version).
struct Geometry {
  bool in_front;
  float depth, hx, hy, pw;
  float q[4];                 // normalised w, x, y, z
  float r[9];                 // rotation, row-major
  float rs[3], s2[3];         // scaled scales and their squares
  float cov[6];               // xx, xy, xz, yy, yz, zz
  float tz_raw, tz, ux, uy, ucx, ucy, tx, ty, inv_z;
  float m[6];                 // rows of J W
  float s[6];                 // Sigma m0 (s0x, s1x, s2x), Sigma m1
  float a, b, c;              // cov2d xx, xy, yy
};

// Column c of [m, 1] @ M for a row-major 4x4 M, as the plain version's
// matrix product rounds it on the card (a chain of fused multiply-adds);
// the file is built without contraction, so elsewhere every operation
// rounds on its own, as the plain version's elementwise ops do.
__device__ __forceinline__ float hom_dot(float mx, float my, float mz,
                                         const float* m, int c) {
  return fmaf(mz, m[8 + c], fmaf(my, m[4 + c], mx * m[c])) + m[12 + c];
}

// |q|^2 in the order of the plain version's 4-wide sum on the card
__device__ __forceinline__ float quat_norm2(const float4& q) {
  return (q.x * q.x + q.z * q.z) + (q.y * q.y + q.w * q.w);
}

__device__ __forceinline__ Geometry geometry(const Args& a, const CamView& cv,
                                             int i) {
  Geometry g;
  const float* v = cv.v;
  const float* p = cv.p;
  const float mx = a.means3d[3 * i], my = a.means3d[3 * i + 1],
              mz = a.means3d[3 * i + 2];
  g.depth = hom_dot(mx, my, mz, v, 2);
  g.in_front = g.depth > kNear;
  g.hx = hom_dot(mx, my, mz, p, 0);
  g.hy = hom_dot(mx, my, mz, p, 1);
  const float hw = hom_dot(mx, my, mz, p, 3);
  g.pw = 1.0f / ((g.in_front ? hw : 1.0f) + kWEps);

  const float4 q = reinterpret_cast<const float4*>(a.quats)[i];
  const float n2 = quat_norm2(q);
  const float rq = rsqrtf(fmaxf(n2, kQuatEps));
  const float w = q.x * rq, x = q.y * rq, y = q.z * rq, z = q.w * rq;
  g.q[0] = w; g.q[1] = x; g.q[2] = y; g.q[3] = z;
  g.r[0] = 1.0f - 2.0f * (y * y + z * z);
  g.r[1] = 2.0f * (x * y - w * z);
  g.r[2] = 2.0f * (x * z + w * y);
  g.r[3] = 2.0f * (x * y + w * z);
  g.r[4] = 1.0f - 2.0f * (x * x + z * z);
  g.r[5] = 2.0f * (y * z - w * x);
  g.r[6] = 2.0f * (x * z - w * y);
  g.r[7] = 2.0f * (y * z + w * x);
  g.r[8] = 1.0f - 2.0f * (x * x + y * y);
  for (int k = 0; k < 3; ++k) {
    g.rs[k] = a.smod * a.scales[3 * i + k];
    g.s2[k] = g.rs[k] * g.rs[k];
  }
  const float* r = g.r;
  const float s0 = g.s2[0], s1 = g.s2[1], s2 = g.s2[2];
  g.cov[0] = r[0] * r[0] * s0 + r[1] * r[1] * s1 + r[2] * r[2] * s2;
  g.cov[1] = r[0] * r[3] * s0 + r[1] * r[4] * s1 + r[2] * r[5] * s2;
  g.cov[2] = r[0] * r[6] * s0 + r[1] * r[7] * s1 + r[2] * r[8] * s2;
  g.cov[3] = r[3] * r[3] * s0 + r[4] * r[4] * s1 + r[5] * r[5] * s2;
  g.cov[4] = r[3] * r[6] * s0 + r[4] * r[7] * s1 + r[5] * r[8] * s2;
  g.cov[5] = r[6] * r[6] * s0 + r[7] * r[7] * s1 + r[8] * r[8] * s2;

  // the EWA step's view position, elementwise in the plain version
  const float tx_ = mx * v[0] + my * v[4] + mz * v[8] + v[12];
  const float ty_ = mx * v[1] + my * v[5] + mz * v[9] + v[13];
  g.tz_raw = mx * v[2] + my * v[6] + mz * v[10] + v[14];
  g.tz = fmaxf(g.tz_raw, kNear);
  g.ux = tx_ / g.tz;
  g.uy = ty_ / g.tz;
  g.ucx = fminf(fmaxf(g.ux, -a.cam.limx), a.cam.limx);
  g.ucy = fminf(fmaxf(g.uy, -a.cam.limy), a.cam.limy);
  g.tx = g.ucx * g.tz;
  g.ty = g.ucy * g.tz;
  g.inv_z = 1.0f / g.tz;
  const float fx = a.cam.focal_x, fy = a.cam.focal_y;
  const float j00 = fx * g.inv_z;
  const float j02 = -(fx * g.tx) * g.inv_z * g.inv_z;
  const float j11 = fy * g.inv_z;
  const float j12 = -(fy * g.ty) * g.inv_z * g.inv_z;
  // vm[k, c] = v[4 k + c]
  g.m[0] = j00 * v[0] + j02 * v[2];
  g.m[1] = j00 * v[4] + j02 * v[6];
  g.m[2] = j00 * v[8] + j02 * v[10];
  g.m[3] = j11 * v[1] + j12 * v[2];
  g.m[4] = j11 * v[5] + j12 * v[6];
  g.m[5] = j11 * v[9] + j12 * v[10];
  const float* c = g.cov;
  const float* m = g.m;
  g.s[0] = c[0] * m[0] + c[1] * m[1] + c[2] * m[2];
  g.s[1] = c[1] * m[0] + c[3] * m[1] + c[4] * m[2];
  g.s[2] = c[2] * m[0] + c[4] * m[1] + c[5] * m[2];
  g.s[3] = c[0] * m[3] + c[1] * m[4] + c[2] * m[5];
  g.s[4] = c[1] * m[3] + c[3] * m[4] + c[4] * m[5];
  g.s[5] = c[2] * m[3] + c[4] * m[4] + c[5] * m[5];
  g.a = m[0] * g.s[0] + m[1] * g.s[1] + m[2] * g.s[2] + kDilation;
  g.b = m[0] * g.s[3] + m[1] * g.s[4] + m[2] * g.s[5];
  g.c = m[3] * g.s[3] + m[4] * g.s[4] + m[5] * g.s[5] + kDilation;
  return g;
}

// The real SH basis (ops/sh.py::sh_basis) and its partials along the
// direction (ops/sh.py::sh_basis_vjp).
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* b) {
  b[0] = kC0;
  if (DEG > 0) {
    b[1] = -kC1 * y;
    b[2] = kC1 * z;
    b[3] = -kC1 * x;
  }
  if (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = kC2[0] * xy;
    b[5] = kC2[1] * yz;
    b[6] = kC2[2] * (2.0f * zz - xx - yy);
    b[7] = kC2[3] * xz;
    b[8] = kC2[4] * (xx - yy);
    if (DEG > 2) {
      b[9] = kC3[0] * y * (3.0f * xx - yy);
      b[10] = kC3[1] * xy * z;
      b[11] = kC3[2] * y * (4.0f * zz - xx - yy);
      b[12] = kC3[3] * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = kC3[4] * x * (4.0f * zz - xx - yy);
      b[14] = kC3[5] * z * (xx - yy);
      b[15] = kC3[6] * x * (xx - 3.0f * yy);
    }
    if (DEG > 3) {
      b[16] = kC4[0] * xy * (xx - yy);
      b[17] = kC4[1] * yz * (3.0f * xx - yy);
      b[18] = kC4[2] * xy * (7.0f * zz - 1.0f);
      b[19] = kC4[3] * yz * (7.0f * zz - 3.0f);
      b[20] = kC4[4] * (zz * (35.0f * zz - 30.0f) + 3.0f);
      b[21] = kC4[5] * xz * (7.0f * zz - 3.0f);
      b[22] = kC4[6] * (xx - yy) * (7.0f * zz - 1.0f);
      b[23] = kC4[7] * xz * (xx - 3.0f * yy);
      b[24] = kC4[8] * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
  }
}

template <int DEG>
__device__ __forceinline__ void sh_basis_vjp(float x, float y, float z,
                                             const float* g, float& gx,
                                             float& gy, float& gz) {
  gx = gy = gz = 0.0f;
  if (DEG > 0) {
    gy += g[1] * -kC1;
    gz += g[2] * kC1;
    gx += g[3] * -kC1;
  }
  if (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    gx += g[4] * (kC2[0] * y);
    gy += g[4] * (kC2[0] * x);
    gy += g[5] * (kC2[1] * z);
    gz += g[5] * (kC2[1] * y);
    gx += g[6] * (-2.0f * kC2[2] * x);
    gy += g[6] * (-2.0f * kC2[2] * y);
    gz += g[6] * (4.0f * kC2[2] * z);
    gx += g[7] * (kC2[3] * z);
    gz += g[7] * (kC2[3] * x);
    gx += g[8] * (2.0f * kC2[4] * x);
    gy += g[8] * (-2.0f * kC2[4] * y);
    if (DEG > 2) {
      gx += g[9] * (kC3[0] * 6.0f * xy);
      gy += g[9] * (kC3[0] * 3.0f * (xx - yy));
      gx += g[10] * (kC3[1] * yz);
      gy += g[10] * (kC3[1] * xz);
      gz += g[10] * (kC3[1] * xy);
      gx += g[11] * (kC3[2] * -2.0f * xy);
      gy += g[11] * (kC3[2] * (4.0f * zz - xx - 3.0f * yy));
      gz += g[11] * (kC3[2] * 8.0f * yz);
      gx += g[12] * (kC3[3] * -6.0f * xz);
      gy += g[12] * (kC3[3] * -6.0f * yz);
      gz += g[12] * (kC3[3] * (6.0f * zz - 3.0f * xx - 3.0f * yy));
      gx += g[13] * (kC3[4] * (4.0f * zz - 3.0f * xx - yy));
      gy += g[13] * (kC3[4] * -2.0f * xy);
      gz += g[13] * (kC3[4] * 8.0f * xz);
      gx += g[14] * (kC3[5] * 2.0f * xz);
      gy += g[14] * (kC3[5] * -2.0f * yz);
      gz += g[14] * (kC3[5] * (xx - yy));
      gx += g[15] * (kC3[6] * 3.0f * (xx - yy));
      gy += g[15] * (kC3[6] * -6.0f * xy);
    }
    if (DEG > 3) {
      gx += g[16] * (kC4[0] * y * (3.0f * xx - yy));
      gy += g[16] * (kC4[0] * x * (xx - 3.0f * yy));
      gx += g[17] * (kC4[1] * 6.0f * xy * z);
      gy += g[17] * (kC4[1] * 3.0f * z * (xx - yy));
      gz += g[17] * (kC4[1] * y * (3.0f * xx - yy));
      gx += g[18] * (kC4[2] * y * (7.0f * zz - 1.0f));
      gy += g[18] * (kC4[2] * x * (7.0f * zz - 1.0f));
      gz += g[18] * (kC4[2] * 14.0f * xy * z);
      gy += g[19] * (kC4[3] * z * (7.0f * zz - 3.0f));
      gz += g[19] * (kC4[3] * y * (21.0f * zz - 3.0f));
      gz += g[20] * (kC4[4] * z * (140.0f * zz - 60.0f));
      gx += g[21] * (kC4[5] * z * (7.0f * zz - 3.0f));
      gz += g[21] * (kC4[5] * x * (21.0f * zz - 3.0f));
      gx += g[22] * (kC4[6] * 2.0f * x * (7.0f * zz - 1.0f));
      gy += g[22] * (kC4[6] * -2.0f * y * (7.0f * zz - 1.0f));
      gz += g[22] * (kC4[6] * 14.0f * z * (xx - yy));
      gx += g[23] * (kC4[7] * 3.0f * z * (xx - yy));
      gy += g[23] * (kC4[7] * -6.0f * xy * z);
      gz += g[23] * (kC4[7] * x * (xx - 3.0f * yy));
      gx += g[24] * (kC4[8] * 4.0f * x * (xx - 3.0f * yy));
      gy += g[24] * (kC4[8] * 4.0f * y * (yy - 3.0f * xx));
    }
  }
}

// The block's camera (35 floats) and, with SH, its rows' first
// (deg + 1)^2 coefficients of each channel into shared memory, by the
// whole block; ends with a barrier.
template <int DEG>
__device__ __forceinline__ CamView stage(const Args& a, float* s_cam,
                                         float* s_sh, int row0, int rows) {
  constexpr int kNb = num_coeffs(DEG);
  constexpr int kCols = 3 * kNb;
  const int t = threadIdx.x;
  if (t < 35)
    s_cam[t] = t < 16 ? a.cam.vm[t] : t < 32 ? a.cam.pm[t - 16]
                                             : a.cam.campos[t - 32];
  if (a.shs != nullptr) {
    for (int e = t; e < rows * kCols; e += kThreads) {
      const int r = e / kCols;
      const int col = e - r * kCols;
      const int ch = col / kNb;
      s_sh[r * row_floats(DEG) + col] =
          a.shs[(row0 + r) * a.sh_stride + ch * a.k + (col - ch * kNb)];
    }
  }
  __syncthreads();
  return CamView{s_cam, s_cam + 16, s_cam + 32};
}

// The unit view direction of Gaussian i and what its VJP needs.
struct ViewDir {
  float d[3];       // p - campos
  float norm, norm_c;
  float x, y, z;    // d / max(|d|, eps)
};

__device__ __forceinline__ ViewDir view_dir(const Args& a, const CamView& cv,
                                            int i) {
  ViewDir vd;
  for (int k = 0; k < 3; ++k) vd.d[k] = a.means3d[3 * i + k] - cv.c[k];
  vd.norm = sqrtf(vd.d[0] * vd.d[0] + vd.d[1] * vd.d[1] + vd.d[2] * vd.d[2]);
  vd.norm_c = fmaxf(vd.norm, kDirEps);
  vd.x = vd.d[0] / vd.norm_c;
  vd.y = vd.d[1] / vd.norm_c;
  vd.z = vd.d[2] / vd.norm_c;
  return vd;
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(const Args a) {
  constexpr int kNb = num_coeffs(DEG);
  extern __shared__ float s_sh[];
  __shared__ float s_cam[35];
  const int row0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, a.n - row0);
  const CamView cv = stage<DEG>(a, s_cam, s_sh, row0, rows);
  const int t = threadIdx.x;
  if (t >= rows) return;
  const int i = row0 + t;
  const Geometry g = geometry(a, cv, i);

  float ndc_x = g.hx * g.pw, ndc_y = g.hy * g.pw;
  if (a.offset != nullptr) {
    ndc_x += a.offset[2 * i];
    ndc_y += a.offset[2 * i + 1];
  }
  const float px = ((ndc_x + 1.0f) * a.cam.width - 1.0f) * 0.5f;
  const float py = ((ndc_y + 1.0f) * a.cam.height - 1.0f) * 0.5f;

  const float det = g.a * g.c - g.b * g.b;
  const bool det_ok = det > 0.0f;
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  const float mid = 0.5f * (g.a + g.c);
  const float disc = sqrtf(fmaxf(mid * mid - det, 0.1f));
  const float lambda_max = mid + disc;
  const float tau = 2.0f * logf(fmaxf(255.0f * a.opac[i], 1e-12f));
  const float r2_max = tau > 0.0f ? tau * fmaxf(lambda_max, 0.0f) : -1.0f;
  const float radius = ceilf(fminf(3.0f * sqrtf(fmaxf(lambda_max, 0.0f)),
                                   sqrtf(fmaxf(r2_max, 0.0f))));
  const float tau_pos = fmaxf(tau, 0.0f);
  const float ext_x =
      fminf(radius, ceilf(sqrtf(tau_pos * fmaxf(g.a, 0.0f))));
  const float ext_y =
      fminf(radius, ceilf(sqrtf(tau_pos * fmaxf(g.c, 0.0f))));
  const int radius_i = (g.in_front && det_ok) ? static_cast<int>(radius) : 0;
  const bool on_screen = px + radius >= 0.0f && px - radius < a.cam.width &&
                         py + radius >= 0.0f && py - radius < a.cam.height;
  const bool valid = g.in_front && det_ok && on_screen && radius_i > 0;

  a.means2d[2 * i] = px;
  a.means2d[2 * i + 1] = py;
  a.depths[i] = g.depth;
  a.conics[3 * i] = g.c * inv_det;
  a.conics[3 * i + 1] = -g.b * inv_det;
  a.conics[3 * i + 2] = g.a * inv_det;
  a.radii[i] = valid ? radius_i : 0;
  a.valid[i] = valid;
  a.r2_max[i] = r2_max;
  a.ext_x[i] = valid ? ext_x : 0.0f;
  a.ext_y[i] = valid ? ext_y : 0.0f;
  a.tau[i] = tau;

  if (a.shs != nullptr) {
    const ViewDir vd = view_dir(a, cv, i);
    float basis[kNb];
    sh_basis<DEG>(vd.x, vd.y, vd.z, basis);
    const float* row = s_sh + t * row_floats(DEG);
    for (int ch = 0; ch < 3; ++ch) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kNb; ++j) acc += basis[j] * row[ch * kNb + j];
      a.colors[3 * i + ch] = fmaxf(acc + 0.5f, 0.0f);
    }
  }
}

__device__ __forceinline__ float cotangent(const float* g, long long stride,
                                           int i, int col) {
  return g == nullptr ? 0.0f : g[i * stride + col];
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(const Args a) {
  constexpr int kNb = num_coeffs(DEG);
  extern __shared__ float s_sh[];
  __shared__ float s_cam[35];
  const int row0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, a.n - row0);
  const CamView cv = stage<DEG>(a, s_cam, s_sh, row0, rows);
  const int t = threadIdx.x;
  const int i = row0 + t;
  if (t < rows) {
    const Geometry g = geometry(a, cv, i);
    const float* v = cv.v;
    const float* p = cv.p;

    // means2d = ndc2pix(p_hom.xy / (w + 1e-7) + offset)
    const float g_ndc_x = cotangent(a.g_means2d, a.gs_means2d, i, 0) * 0.5f *
                          a.cam.width;
    const float g_ndc_y = cotangent(a.g_means2d, a.gs_means2d, i, 1) * 0.5f *
                          a.cam.height;
    a.d_offset[2 * i] = g_ndc_x;
    a.d_offset[2 * i + 1] = g_ndc_y;
    const float g_hx = g_ndc_x * g.pw, g_hy = g_ndc_y * g.pw;
    const float g_pw = g_ndc_x * g.hx + g_ndc_y * g.hy;
    const float g_hw = g.in_front ? -g_pw * g.pw * g.pw : 0.0f;
    float g_m[3];
    for (int k = 0; k < 3; ++k)
      g_m[k] = g_hx * p[4 * k] + g_hy * p[4 * k + 1] + g_hw * p[4 * k + 3];

    // conic = (yy, -xy, xx) / det, det = xx yy - xy^2
    const float det = g.a * g.c - g.b * g.b;
    const bool det_ok = det > 0.0f;
    const float inv_det = 1.0f / (det_ok ? det : 1.0f);
    const float g0 = cotangent(a.g_conics, a.gs_conics, i, 0);
    const float g1 = cotangent(a.g_conics, a.gs_conics, i, 1);
    const float g2 = cotangent(a.g_conics, a.gs_conics, i, 2);
    const float g_inv = g0 * g.c - g1 * g.b + g2 * g.a;
    const float g_det = det_ok ? -g_inv * inv_det * inv_det : 0.0f;
    const float g_a = g2 * inv_det + g_det * g.c;
    const float g_b = -g1 * inv_det - 2.0f * g.b * g_det;
    const float g_c = g0 * inv_det + g_det * g.a;

    // a = m0 Sigma m0 + 0.3, b = m0 Sigma m1, c = m1 Sigma m1 + 0.3
    const float* m = g.m;
    const float* s = g.s;
    float gm[6];
    for (int k = 0; k < 3; ++k) {
      gm[k] = 2.0f * g_a * s[k] + g_b * s[3 + k];
      gm[3 + k] = 2.0f * g_c * s[3 + k] + g_b * s[k];
    }
    const float g_cxx = g_a * m[0] * m[0] + g_b * m[0] * m[3] +
                        g_c * m[3] * m[3];
    const float g_cyy = g_a * m[1] * m[1] + g_b * m[1] * m[4] +
                        g_c * m[4] * m[4];
    const float g_czz = g_a * m[2] * m[2] + g_b * m[2] * m[5] +
                        g_c * m[5] * m[5];
    const float g_cxy = 2.0f * g_a * m[0] * m[1] +
                        g_b * (m[0] * m[4] + m[1] * m[3]) +
                        2.0f * g_c * m[3] * m[4];
    const float g_cxz = 2.0f * g_a * m[0] * m[2] +
                        g_b * (m[0] * m[5] + m[2] * m[3]) +
                        2.0f * g_c * m[3] * m[5];
    const float g_cyz = 2.0f * g_a * m[1] * m[2] +
                        g_b * (m[1] * m[5] + m[2] * m[4]) +
                        2.0f * g_c * m[4] * m[5];

    // M = J W: the Jacobian at the clamped view position
    const float g_j00 = gm[0] * v[0] + gm[1] * v[4] + gm[2] * v[8];
    const float g_j02 = gm[0] * v[2] + gm[1] * v[6] + gm[2] * v[10];
    const float g_j11 = gm[3] * v[1] + gm[4] * v[5] + gm[5] * v[9];
    const float g_j12 = gm[3] * v[2] + gm[4] * v[6] + gm[5] * v[10];
    const float fx = a.cam.focal_x, fy = a.cam.focal_y;
    const float iz2 = g.inv_z * g.inv_z;
    const float g_tx = -(fx * iz2) * g_j02;
    const float g_ty = -(fy * iz2) * g_j12;
    const float g_iz = fx * g_j00 + fy * g_j11 -
                       2.0f * (fx * g.tx) * g.inv_z * g_j02 -
                       2.0f * (fy * g.ty) * g.inv_z * g_j12;
    const float g_ux =
        (g.ux >= -a.cam.limx && g.ux <= a.cam.limx) ? g_tx * g.tz : 0.0f;
    const float g_uy =
        (g.uy >= -a.cam.limy && g.uy <= a.cam.limy) ? g_ty * g.tz : 0.0f;
    const float g_tz = -g_iz * iz2 + g_tx * g.ucx + g_ty * g.ucy -
                       (g_ux * g.ux + g_uy * g.uy) / g.tz;
    const float g_tz_ = g.tz_raw >= kNear ? g_tz : 0.0f;
    const float g_tx_ = g_ux / g.tz, g_ty_ = g_uy / g.tz;
    for (int k = 0; k < 3; ++k)
      g_m[k] += g_tx_ * v[4 * k] + g_ty_ * v[4 * k + 1] + g_tz_ * v[4 * k + 2];

    // Sigma = R diag(s^2) R^T
    const float* r = g.r;
    float gr[9];
    for (int k = 0; k < 3; ++k) {
      const float ra = r[k], rb = r[3 + k], rc = r[6 + k];
      const float g_sk = g_cxx * ra * ra + g_cyy * rb * rb + g_czz * rc * rc +
                         g_cxy * ra * rb + g_cxz * ra * rc + g_cyz * rb * rc;
      a.d_scales[3 * i + k] = g_sk * 2.0f * g.rs[k] * a.smod;
      gr[k] = g.s2[k] * (2.0f * g_cxx * ra + g_cxy * rb + g_cxz * rc);
      gr[3 + k] = g.s2[k] * (g_cxy * ra + 2.0f * g_cyy * rb + g_cyz * rc);
      gr[6 + k] = g.s2[k] * (g_cxz * ra + g_cyz * rb + 2.0f * g_czz * rc);
    }
    const float w = g.q[0], x = g.q[1], y = g.q[2], z = g.q[3];
    const float g_w = 2.0f * (-z * gr[1] + y * gr[2] + z * gr[3] -
                              x * gr[5] - y * gr[6] + x * gr[7]);
    const float g_x = 2.0f * (y * gr[1] + z * gr[2] + y * gr[3] -
                              2.0f * x * gr[4] - w * gr[5] + z * gr[6] +
                              w * gr[7] - 2.0f * x * gr[8]);
    const float g_y = 2.0f * (-2.0f * y * gr[0] + x * gr[1] + w * gr[2] +
                              x * gr[3] + z * gr[5] - w * gr[6] + z * gr[7] -
                              2.0f * y * gr[8]);
    const float g_z = 2.0f * (-2.0f * z * gr[0] - w * gr[1] + x * gr[2] +
                              w * gr[3] - 2.0f * z * gr[4] + y * gr[5] +
                              x * gr[6] + y * gr[7]);
    // q / sqrt(max(|q|^2, eps))
    const float4 q = reinterpret_cast<const float4*>(a.quats)[i];
    const float n2 = quat_norm2(q);
    const float rq = rsqrtf(fmaxf(n2, kQuatEps));
    const float dot = g_w * q.x + g_x * q.y + g_y * q.z + g_z * q.w;
    const float c_q = n2 >= kQuatEps ? -(rq * rq * rq) * dot : 0.0f;
    reinterpret_cast<float4*>(a.d_quats)[i] =
        make_float4(g_w * rq + c_q * q.x, g_x * rq + c_q * q.y,
                    g_y * rq + c_q * q.z, g_z * rq + c_q * q.w);

    if (a.shs != nullptr) {
      // color = max(sum_k basis_k sh_ck + 0.5, 0)
      const ViewDir vd = view_dir(a, cv, i);
      float basis[kNb];
      sh_basis<DEG>(vd.x, vd.y, vd.z, basis);
      float* row = s_sh + t * row_floats(DEG);
      float g_basis[kNb];
#pragma unroll
      for (int j = 0; j < kNb; ++j) g_basis[j] = 0.0f;
      for (int ch = 0; ch < 3; ++ch) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kNb; ++j) acc += basis[j] * row[ch * kNb + j];
        const float g_raw = acc + 0.5f >= 0.0f
                                ? cotangent(a.g_colors, a.gs_colors, i, ch)
                                : 0.0f;
#pragma unroll
        for (int j = 0; j < kNb; ++j) {
          g_basis[j] += g_raw * row[ch * kNb + j];
          row[ch * kNb + j] = g_raw * basis[j];   // the row's SH gradient
        }
      }
      float gx, gy, gz;
      sh_basis_vjp<DEG>(vd.x, vd.y, vd.z, g_basis, gx, gy, gz);
      // d / max(|d|, eps)
      const float dotd = gx * vd.d[0] + gy * vd.d[1] + gz * vd.d[2];
      const float g_norm = vd.norm >= kDirEps
                               ? -dotd / (vd.norm_c * vd.norm_c * vd.norm)
                               : 0.0f;
      g_m[0] += gx / vd.norm_c + g_norm * vd.d[0];
      g_m[1] += gy / vd.norm_c + g_norm * vd.d[1];
      g_m[2] += gz / vd.norm_c + g_norm * vd.d[2];
    }
    for (int k = 0; k < 3; ++k) a.d_means3d[3 * i + k] = g_m[k];
  }
  if (a.shs == nullptr) return;
  // the block's SH gradient rows, whole (zeros past the degree's
  // coefficients), neighbouring threads on neighbouring addresses
  __syncthreads();
  const int cols = 3 * a.k;
  int r = t / cols, col = t - r * cols;
  for (int e = t; e < rows * cols; e += kThreads) {
    const int ch = col >= 2 * a.k ? 2 : col >= a.k ? 1 : 0;
    const int j = col - ch * a.k;
    a.d_shs[static_cast<long long>(row0) * cols + e] =
        j < kNb ? s_sh[r * row_floats(DEG) + ch * kNb + j] : 0.0f;
    col += kThreads;
    while (col >= cols) {
      col -= cols;
      ++r;
    }
  }
}

template <int DEG>
cudaError_t launch(const Args& a, bool backward, cudaStream_t s) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  const size_t shared =
      a.shs == nullptr ? 0 : sizeof(float) * kThreads * row_floats(DEG);
  if (backward)
    project_bwd_kernel<DEG><<<blocks, kThreads, shared, s>>>(a);
  else
    project_fwd_kernel<DEG><<<blocks, kThreads, shared, s>>>(a);
  return cudaGetLastError();
}

int dispatch(const Args& a, int sh_degree, bool backward, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.n <= 0) return static_cast<int>(cudaGetLastError());
  switch (a.shs == nullptr ? 0 : sh_degree) {
    case 0: return static_cast<int>(launch<0>(a, backward, s));
    case 1: return static_cast<int>(launch<1>(a, backward, s));
    case 2: return static_cast<int>(launch<2>(a, backward, s));
    case 3: return static_cast<int>(launch<3>(a, backward, s));
    case 4: return static_cast<int>(launch<4>(a, backward, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Camera camera(const float* vm, const float* pm, const float* campos,
              float limx, float limy, float focal_x, float focal_y, int width,
              int height) {
  return Camera{vm, pm, campos, limx, limy, focal_x, focal_y, width, height};
}

}  // namespace

// Forward. means3d, scales: (n, 3); quats: (n, 4), 16-byte aligned;
// opac: (n,); shs: (n, 3k) with rows sh_stride floats apart, or null (no
// colours); offset: (n, 2) or null; viewmatrix, projmatrix: (4, 4) and
// campos: (3,) on the device; every array float32 and contiguous. Outputs
// (n, 2) means2d, (n,) depths, (n, 3) conics, (n, 3) colors (unless shs is
// null), (n,) int32 radii, (n,) bool valid, (n,) r2_max, ext_x, ext_y, tau.
// Launches on `stream` and returns the CUDA error (0 on success).
extern "C" int project_fwd(
    int n, const float* means3d, const float* scales, const float* quats,
    const float* opac, const float* shs, long long sh_stride, int k,
    int sh_degree, const float* offset, const float* viewmatrix,
    const float* projmatrix, const float* campos, float limx, float limy,
    float focal_x, float focal_y, int width, int height, float smod,
    float* means2d, float* depths, float* conics, float* colors, int* radii,
    unsigned char* valid, float* r2_max, float* ext_x, float* ext_y,
    float* tau, void* stream) {
  Args a = {};
  a.n = n;
  a.means3d = means3d;
  a.scales = scales;
  a.quats = quats;
  a.opac = opac;
  a.shs = shs;
  a.sh_stride = sh_stride;
  a.k = k;
  a.offset = offset;
  a.cam = camera(viewmatrix, projmatrix, campos, limx, limy, focal_x, focal_y,
                 width, height);
  a.smod = smod;
  a.means2d = means2d;
  a.depths = depths;
  a.conics = conics;
  a.colors = colors;
  a.radii = radii;
  a.valid = valid;
  a.r2_max = r2_max;
  a.ext_x = ext_x;
  a.ext_y = ext_y;
  a.tau = tau;
  return dispatch(a, sh_degree, false, stream);
}

// Backward. The inputs as for project_fwd (no opacity, no offset); the
// cotangents of means2d (n, 2), conics (n, 3) and colors (n, 3), each
// float32 with unit column stride and rows g_*_stride floats apart, or null
// (zero). Writes every row of d_means3d (n, 3), d_scales (n, 3), d_quats
// (n, 4; 16-byte aligned), d_shs (n, 3k; contiguous; unless shs is null)
// and d_offset (n, 2). Launches on `stream` and returns the CUDA error.
extern "C" int project_bwd(
    int n, const float* means3d, const float* scales, const float* quats,
    const float* shs, long long sh_stride, int k, int sh_degree,
    const float* viewmatrix, const float* projmatrix, const float* campos,
    float limx, float limy, float focal_x, float focal_y, int width,
    int height, float smod, const float* g_means2d, long long gs_means2d,
    const float* g_conics, long long gs_conics, const float* g_colors,
    long long gs_colors, float* d_means3d, float* d_scales, float* d_quats,
    float* d_shs, float* d_offset, void* stream) {
  Args a = {};
  a.n = n;
  a.means3d = means3d;
  a.scales = scales;
  a.quats = quats;
  a.shs = shs;
  a.sh_stride = sh_stride;
  a.k = k;
  a.cam = camera(viewmatrix, projmatrix, campos, limx, limy, focal_x, focal_y,
                 width, height);
  a.smod = smod;
  a.g_means2d = g_means2d;
  a.gs_means2d = gs_means2d;
  a.g_conics = g_conics;
  a.gs_conics = gs_conics;
  a.g_colors = g_colors;
  a.gs_colors = gs_colors;
  a.d_means3d = d_means3d;
  a.d_scales = d_scales;
  a.d_quats = d_quats;
  a.d_shs = d_shs;
  a.d_offset = d_offset;
  return dispatch(a, sh_degree, true, stream);
}
