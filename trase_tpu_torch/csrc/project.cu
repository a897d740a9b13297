// The projection stage of a render in two launches: project_fwd_kernel
// computes each gaussian row's 3D covariance, EWA projection (screen mean,
// depth, conic, radius, visibility, exact-support extent) and SH colour;
// project_bwd_kernel recomputes the row from its inputs and writes the
// gradients of the means, scales, rotations and SH coefficients.
//
// Replaces no Pallas kernel: trase_tpu leaves ops/projection.py
// (compute_cov3d, project_gaussians, sh_basis) to XLA's fusion. The port's
// plain version (trase_tpu_torch/ops/projection.py, the same functions)
// launches some 200 elementwise ops a render and keeps as many autograd nodes
// for the backward, each a launch the host pays for. Here one thread owns one
// row, and the host makes one launch each way.
//
// Arithmetic (forward): the plain version's expressions in its order, in
// float32, each product, sum and quotient rounded on its own (NVCC_FLAGS has
// -fmad=false; division and sqrtf are IEEE; logf is the CUDA math library's,
// as PyTorch's), constants rounded from their double values as PyTorch rounds
// a Python float, and clamp / minimum / maximum propagating NaN as PyTorch's
// do. So mean2d, depth, conic, radius, valid and extent are the plain
// version's bit for bit on the card; the rotation's norm sums its four
// squares in the order of PyTorch's warp reduction (quat_norm), and the
// colour's sum over the coefficients in torch.sum's order (sh_sum).
//
// Backward: autograd's backward of the plain version replayed op by op in
// float32: each op's gradient formula as PyTorch's derivatives write it
// (reciprocal: -g (r r); division: g / b and -g ((a / b) / b); sqrt: g / (2
// r)), and a value with several consumers summing their gradients in the
// order autograd's engine runs them, the last-created consumer first; sums
// of four in the warp reduction's order (sum4). So the gradients of the
// means, scales, rotations and coefficients agree with autograd's through
// the plain version to rounding, mostly bit for bit. Its conventions hold:
// clamp passes the gradient inside its bounds, inclusive; torch.where sends
// zero to the branch not taken (the rows behind znear divide by the
// sanitised tz = 1); radius, valid and extent carry none; the colour's
// clamp(min=0) passes where its input is >= 0; the coefficients past the ones
// used get zero. The mean2d cotangent is the screen-space offset's gradient
// unchanged, which the wrapper returns. Absent cotangents (null pointers)
// count as zero.
//
// Bound: bytes. A row reads 44 bytes of geometry and up to 192 of SH
// coefficients and writes 49 (forward); the backward reads the same inputs
// and 36 bytes of cotangents and writes 232. chip_smoke.py counts them.
//
// Design: one thread a row, 128-thread blocks; the camera (two 4x4 matrices,
// its centre and half-angle tangents, 38 floats on the device, so nothing is
// read back to the host) is read through the read-only path, the same words
// by every thread of a warp. Every intermediate is recomputed in the backward
// from the row's inputs (about 100 floats of registers), so the forward saves
// nothing for it. A row's SH coefficients (up to 48 floats, 192 bytes apart
// from the next row's) would be read and their gradients written a float a
// thread at strides no warp access coalesces; the backward stages the
// block's rows in shared memory instead (stage_coeffs, store_coeff_grads),
// read and written by consecutive threads.
#include <cstdint>

#include <cuda_runtime.h>

// The arguments of both kernels, mirrored by ops/project_cuda.py (outside the
// unnamed namespace: the C entry points take it).
struct ProjectArgs {
  const float* means;       // (n, 3)
  const float* scales;      // (n, 3) activated
  const float* rots;        // (n, 4) wxyz
  const float* opacity;     // (n,)
  const float* offset;      // (n, 2) added to mean2d, or null
  const float* dc;          // (n, 1, 3) SH degree 0, or null: no colour
  const float* rest;        // (n, n_rest, 3) higher degrees
  const float* world_view;  // (4, 4) row-vector convention
  const float* full_proj;   // (4, 4)
  const float* campos;      // (3,)
  const float* tanfovx;     // 0-d
  const float* tanfovy;     // 0-d
  float* mean2d;            // (n, 2)
  float* depth;             // (n,)
  float* conic;             // (n, 3)
  float* radius;            // (n,)
  uint8_t* valid;           // (n,) bool
  float* extent;            // (n, 2)
  float* color;             // (n, 3), written with dc
  const float* g_mean2d;    // cotangents (n, 2), (n,), (n, 3), (n, 3) or
                            // null, each row's floats consecutive
  const float* g_depth;
  const float* g_conic;
  const float* g_color;
  float* d_means;           // gradients (n, 3), (n, 3), (n, 4)
  float* d_scales;
  float* d_rots;
  float* d_dc;              // (n, 1, 3), (n, n_rest, 3), written with dc
  float* d_rest;
  int32_t gs_mean2d;        // the cotangents' row strides, in floats
  int32_t gs_depth;
  int32_t gs_conic;
  int32_t gs_color;
  int32_t n;
  int32_t n_rest;
  int32_t n_basis;          // coefficients used: min((deg+1)^2, 1 + n_rest)
  int32_t height;
  int32_t width;
  float scale_modifier;
  float znear;
};

namespace {

constexpr int kThreads = 128;

// Python floats as PyTorch rounds them to float32
#define F32(x) ((float)(x))

// the plain version's constants (ops/projection.py, utils/sh.py)
__device__ __constant__ float kC0 = F32(0.28209479177387814);
__device__ __constant__ float kC1 = F32(0.4886025119029199);
__device__ __constant__ float kC2[5] = {
    F32(1.0925484305920792), F32(-1.0925484305920792),
    F32(0.31539156525252005), F32(-1.0925484305920792),
    F32(0.5462742152960396)};
__device__ __constant__ float kC3[7] = {
    F32(-0.5900435899266435), F32(2.890611442640554),
    F32(-0.4570457994644658), F32(0.3731763325901154),
    F32(-0.4570457994644658), F32(1.445305721320277),
    F32(-0.5900435899266435)};

// torch.clamp / clamp(min=) / torch.minimum on CUDA: NaN in, NaN out
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  if (v != v) return v;
  return fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min_t(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float minimum_t(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

// torch.linalg.norm over a row of four: each lane squares one element and a
// warp reduction with falling offsets (2, then 1) adds lanes 0 + 2 and 1 + 3,
// then the two sums
__device__ __forceinline__ float quat_norm(float w, float x, float y, float z) {
  return sqrtf((w * w + y * y) + (x * x + z * z));
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

// world_view / full_proj [i, j]
__device__ __forceinline__ float at(const float* m, int i, int j) {
  return __ldg(m + 4 * i + j);
}

// Everything the plain version computes for one row before its culling,
// radius and colour, kept for the backward's reverse pass.
struct Geo {
  // rotation: input, norm, unit quaternion, matrix
  float r[4], nr, q[4], R[3][3];
  // scales: sm * s and its square
  float ss[3], S[3];
  // packed covariance xx, xy, xz, yy, yz, zz
  float cov[6];
  // view space, clip space
  float tx, ty, tz_raw, tz, hx, hy, hw, p_w, px, py;
  bool behind;
  // the Jacobian's clamp, its entries and T = J W
  float u, v, limx, limy, uc, vc, txtz, tytz, fx, fy, inv_tz;
  float ex, ey;  // -(fx * txtz), -(fy * tytz)
  float exi, eyi;  // ex * inv_tz, ey * inv_tz
  float j00, j02, j11, j12;
  float t0[3], t1[3];
  float s0t0, s1t0, s2t0, s0t1, s1t1, s2t1;
  float a, b, c, det, det_inv;
};

__device__ __forceinline__ void geometry(const ProjectArgs& A, int i, Geo& g) {
  const float* WV = A.world_view;
  const float* FP = A.full_proj;
  // compute_cov3d
  for (int k = 0; k < 4; ++k) g.r[k] = ld(A.rots + 4 * i + k);
  g.nr = quat_norm(g.r[0], g.r[1], g.r[2], g.r[3]);
  for (int k = 0; k < 4; ++k) g.q[k] = g.r[k] / g.nr;
  const float w = g.q[0], x = g.q[1], y = g.q[2], z = g.q[3];
  g.R[0][0] = 1.0f - 2.0f * (y * y + z * z);
  g.R[0][1] = 2.0f * (x * y - w * z);
  g.R[0][2] = 2.0f * (x * z + w * y);
  g.R[1][0] = 2.0f * (x * y + w * z);
  g.R[1][1] = 1.0f - 2.0f * (x * x + z * z);
  g.R[1][2] = 2.0f * (y * z - w * x);
  g.R[2][0] = 2.0f * (x * z - w * y);
  g.R[2][1] = 2.0f * (y * z + w * x);
  g.R[2][2] = 1.0f - 2.0f * (x * x + y * y);
  for (int k = 0; k < 3; ++k) {
    g.ss[k] = A.scale_modifier * ld(A.scales + 3 * i + k);
    g.S[k] = g.ss[k] * g.ss[k];
  }
  const int rows[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
  for (int e = 0; e < 6; ++e) {
    const float* Ra = g.R[rows[e][0]];
    const float* Rb = g.R[rows[e][1]];
    g.cov[e] = g.S[0] * Ra[0] * Rb[0] + g.S[1] * Ra[1] * Rb[1] +
               g.S[2] * Ra[2] * Rb[2];
  }

  // project_gaussians
  const float mx = ld(A.means + 3 * i), my = ld(A.means + 3 * i + 1),
              mz = ld(A.means + 3 * i + 2);
  g.tx = mx * at(WV, 0, 0) + my * at(WV, 1, 0) + mz * at(WV, 2, 0) +
         at(WV, 3, 0);
  g.ty = mx * at(WV, 0, 1) + my * at(WV, 1, 1) + mz * at(WV, 2, 1) +
         at(WV, 3, 1);
  g.tz_raw = mx * at(WV, 0, 2) + my * at(WV, 1, 2) + mz * at(WV, 2, 2) +
             at(WV, 3, 2);
  g.behind = g.tz_raw <= A.znear;
  g.tz = g.behind ? 1.0f : g.tz_raw;

  g.hx = mx * at(FP, 0, 0) + my * at(FP, 1, 0) + mz * at(FP, 2, 0) +
         at(FP, 3, 0);
  g.hy = mx * at(FP, 0, 1) + my * at(FP, 1, 1) + mz * at(FP, 2, 1) +
         at(FP, 3, 1);
  g.hw = mx * at(FP, 0, 3) + my * at(FP, 1, 3) + mz * at(FP, 2, 3) +
         at(FP, 3, 3);
  g.p_w = 1.0f / (g.hw + F32(1e-7));
  g.px = ((g.hx * g.p_w + 1.0f) * (float)A.width - 1.0f) * 0.5f;
  g.py = ((g.hy * g.p_w + 1.0f) * (float)A.height - 1.0f) * 0.5f;

  const float tanx = ld(A.tanfovx), tany = ld(A.tanfovy);
  g.limx = F32(1.3) * tanx;
  g.limy = F32(1.3) * tany;
  g.u = g.tx / g.tz;
  g.v = g.ty / g.tz;
  g.uc = clamp_t(g.u, -g.limx, g.limx);
  g.vc = clamp_t(g.v, -g.limy, g.limy);
  g.txtz = g.uc * g.tz;
  g.tytz = g.vc * g.tz;
  g.fx = (float)A.width / (2.0f * tanx);
  g.fy = (float)A.height / (2.0f * tany);

  g.inv_tz = 1.0f / g.tz;
  g.j00 = g.fx * g.inv_tz;
  g.ex = -(g.fx * g.txtz);
  g.exi = g.ex * g.inv_tz;
  g.j02 = g.exi * g.inv_tz;
  g.j11 = g.fy * g.inv_tz;
  g.ey = -(g.fy * g.tytz);
  g.eyi = g.ey * g.inv_tz;
  g.j12 = g.eyi * g.inv_tz;
  for (int k = 0; k < 3; ++k) {
    g.t0[k] = g.j00 * at(WV, k, 0) + g.j02 * at(WV, k, 2);
    g.t1[k] = g.j11 * at(WV, k, 1) + g.j12 * at(WV, k, 2);
  }

  const float cxx = g.cov[0], cxy = g.cov[1], cxz = g.cov[2];
  const float cyy = g.cov[3], cyz = g.cov[4], czz = g.cov[5];
  const float* t0 = g.t0;
  const float* t1 = g.t1;
  g.s0t0 = cxx * t0[0] + cxy * t0[1] + cxz * t0[2];
  g.s1t0 = cxy * t0[0] + cyy * t0[1] + cyz * t0[2];
  g.s2t0 = cxz * t0[0] + cyz * t0[1] + czz * t0[2];
  g.s0t1 = cxx * t1[0] + cxy * t1[1] + cxz * t1[2];
  g.s1t1 = cxy * t1[0] + cyy * t1[1] + cyz * t1[2];
  g.s2t1 = cxz * t1[0] + cyz * t1[1] + czz * t1[2];
  g.a = t0[0] * g.s0t0 + t0[1] * g.s1t0 + t0[2] * g.s2t0 + F32(0.3);
  g.b = t0[0] * g.s0t1 + t0[1] * g.s1t1 + t0[2] * g.s2t1;
  g.c = t1[0] * g.s0t1 + t1[1] * g.s1t1 + t1[2] * g.s2t1 + F32(0.3);

  g.det = g.a * g.c - g.b * g.b;
  g.det_inv = 1.0f / (g.det + F32(1e-12));
}

// The view direction's unit vector (the plain version's x, y, z) and what
// the backward needs of its normalisation.
struct Dir {
  float d[3], sq, len, inv_n, x, y, z;
};

__device__ __forceinline__ void direction(const ProjectArgs& A, int i,
                                          Dir& o) {
  for (int k = 0; k < 3; ++k)
    o.d[k] = ld(A.means + 3 * i + k) - ld(A.campos + k);
  o.sq = o.d[0] * o.d[0] + o.d[1] * o.d[1] + o.d[2] * o.d[2] + F32(1e-18);
  o.len = sqrtf(o.sq);
  o.inv_n = 1.0f / o.len;
  o.x = o.d[0] * o.inv_n;
  o.y = o.d[1] * o.inv_n;
  o.z = o.d[2] * o.inv_n;
}

// sh_basis: the first nb of the 16 real SH basis values
__device__ __forceinline__ void basis(int nb, float x, float y, float z,
                                      float* bas) {
  bas[0] = kC0;
  if (nb <= 1) return;
  bas[1] = -kC1 * y;
  bas[2] = kC1 * z;
  bas[3] = -kC1 * x;
  if (nb <= 4) return;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  bas[4] = kC2[0] * xy;
  bas[5] = kC2[1] * yz;
  bas[6] = kC2[2] * (2.0f * zz - xx - yy);
  bas[7] = kC2[3] * xz;
  bas[8] = kC2[4] * (xx - yy);
  if (nb <= 9) return;
  bas[9] = kC3[0] * y * (3.0f * xx - yy);
  bas[10] = kC3[1] * xy * z;
  bas[11] = kC3[2] * y * (4.0f * zz - xx - yy);
  bas[12] = kC3[3] * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  bas[13] = kC3[4] * x * (4.0f * zz - xx - yy);
  bas[14] = kC3[5] * z * (xx - yy);
  bas[15] = kC3[6] * x * (xx - 3.0f * yy);
}

// Row i's SH coefficient k, channel ch, from device memory: dc for k = 0,
// else rest.
struct GlobalCoeffs {
  const ProjectArgs& A;
  int i;
  __device__ __forceinline__ float operator()(int k, int ch) const {
    return k == 0 ? ld(A.dc + 3 * i + ch)
                  : ld(A.rest + ((int64_t)i * A.n_rest + (k - 1)) * 3 + ch);
  }
};

// The same from a row staged in shared memory: coefficient k at 3 k.
struct SharedCoeffs {
  const float* row;
  __device__ __forceinline__ float operator()(int k, int ch) const {
    return row[3 * k + ch];
  }
};

// the colour before its clamp: sum_k basis_k coeff_k + 0.5, per channel,
// over the first nb coefficients, in the order of torch.sum over them (its
// reduction over a leading dimension: one thread sums a column in four
// accumulators, coefficient k into k mod 4, then adds them in order); the
// loops unrolled to 16, so the arrays stay in registers
template <class Coeffs>
__device__ __forceinline__ void sh_sum(const Coeffs& coeff, int nb,
                                       const float* bas, float* pre) {
  float acc[3][4] = {};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < nb)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        acc[ch][k % 4] = acc[ch][k % 4] + bas[k] * coeff(k, ch);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    pre[ch] = (((acc[ch][0] + acc[ch][1]) + acc[ch][2]) + acc[ch][3]) + 0.5f;
}

__global__ void __launch_bounds__(kThreads)
    project_fwd_kernel(const __grid_constant__ ProjectArgs A) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= A.n) return;
  Geo g;
  geometry(A, i, g);

  const float mid = 0.5f * (g.a + g.c);
  const float lambda1 =
      mid + sqrtf(clamp_min_t(mid * mid - g.det, F32(0.1)));
  float radius = ceilf(3.0f * sqrtf(lambda1));
  const float opa = ld(A.opacity + i);
  bool valid = !g.behind && (g.det > 0.0f) && (opa > 0.0f);
  const bool in_image = (g.px + radius > 0.0f) &&
                        (g.px - radius < (float)A.width) &&
                        (g.py + radius > 0.0f) &&
                        (g.py - radius < (float)A.height);
  valid = valid && in_image;
  radius = valid ? radius : 0.0f;

  // exact-support extent: t_sup = 2 (log(max(o, 1e-38)) - log(1/255))
  float t_sup = 2.0f * (logf(clamp_min_t(opa, F32(1e-38))) -
                        F32(-5.541263545158426));
  t_sup = clamp_min_t(t_sup, 0.0f);
  const float pad = F32(1.0000004768371582);  // 1 + 4 eps(float32)
  const float ex =
      minimum_t(sqrtf(t_sup * clamp_min_t(g.a, 0.0f)) * pad, radius);
  const float ey =
      minimum_t(sqrtf(t_sup * clamp_min_t(g.c, 0.0f)) * pad, radius);

  float px = g.px, py = g.py;
  if (A.offset) {
    px = px + ld(A.offset + 2 * i);
    py = py + ld(A.offset + 2 * i + 1);
  }
  A.mean2d[2 * i] = px;
  A.mean2d[2 * i + 1] = py;
  A.depth[i] = g.tz;
  A.conic[3 * i] = g.c * g.det_inv;
  A.conic[3 * i + 1] = -g.b * g.det_inv;
  A.conic[3 * i + 2] = g.a * g.det_inv;
  A.radius[i] = radius;
  A.valid[i] = valid;
  A.extent[2 * i] = valid ? ex : 0.0f;
  A.extent[2 * i + 1] = valid ? ey : 0.0f;

  if (A.dc) {
    Dir d;
    direction(A, i, d);
    float bas[16], pre[3];
    basis(A.n_basis, d.x, d.y, d.z, bas);
    sh_sum(GlobalCoeffs{A, i}, A.n_basis, bas, pre);
    for (int ch = 0; ch < 3; ++ch)
      A.color[3 * i + ch] = clamp_min_t(pre[ch], 0.0f);
  }
}

__device__ __forceinline__ float cot(const float* p, int64_t k) {
  return p ? ld(p + k) : 0.0f;
}

// a sum of four as PyTorch's reduction over a row of four adds it (the
// order of quat_norm)
__device__ __forceinline__ float sum4(float a0, float a1, float a2, float a3) {
  return (a0 + a2) + (a1 + a3);
}

// The backward stages a block's SH coefficients in shared memory, row t of
// the block at t kShStride: dc, then the rest coefficients below n_basis
// (at most 15), read from device memory by consecutive threads; the row's
// gradients are written over it, and stored to device memory the same way.
// The odd stride puts a warp's 32 rows in 32 banks.
constexpr int kShStride = 49;

// Stage the coefficients of the block's `rows` rows from row r0.
__device__ __forceinline__ void stage_coeffs(const ProjectArgs& A, int r0,
                                             int rows, float* sh) {
  for (int j = threadIdx.x; j < 3 * rows; j += kThreads)
    sh[(j / 3) * kShStride + j % 3] = ld(A.dc + 3 * (int64_t)r0 + j);
  const int used = 3 * min(A.n_rest, A.n_basis - 1);
  for (int j = threadIdx.x; j < used * rows; j += kThreads) {
    const int t = j / used, c = j % used;
    sh[t * kShStride + 3 + c] =
        ld(A.rest + ((int64_t)r0 + t) * 3 * A.n_rest + c);
  }
}

// Store the gradients staged over the coefficients: dc's, then every rest
// coefficient's (zero past the 15 staged).
__device__ __forceinline__ void store_coeff_grads(const ProjectArgs& A, int r0,
                                                  int rows, const float* sh) {
  for (int j = threadIdx.x; j < 3 * rows; j += kThreads)
    A.d_dc[3 * (int64_t)r0 + j] = sh[(j / 3) * kShStride + j % 3];
  const int width = 3 * A.n_rest;
  for (int j = threadIdx.x; j < width * rows; j += kThreads) {
    const int t = j / width, c = j % width;
    A.d_rest[(int64_t)r0 * width + j] =
        c < 45 ? sh[t * kShStride + 3 + c] : 0.0f;
  }
}

// The SH colour's gradient, replayed as autograd runs sh_basis and the
// colour's sums backward: writes the coefficients' gradients over the row's
// staged coefficients `row` and returns the gradient of the view
// direction's d = means - campos in gd.
__device__ __forceinline__ void sh_backward(const ProjectArgs& A, int i,
                                            float* row, float* gd) {
  Dir d;
  direction(A, i, d);
  const int nb = A.n_basis;
  const SharedCoeffs coeff{row};
  float bas[16], pre[3], gp[3];
  basis(nb, d.x, d.y, d.z, bas);
  sh_sum(coeff, nb, bas, pre);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    gp[ch] = pre[ch] >= 0.0f ? cot(A.g_color, (int64_t)A.gs_color * i + ch)
                             : 0.0f;

  // the basis values' gradients: one slice of the basis a channel, summed
  // channel 2 first; zero past n_basis
  float gb[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    gb[k] = 0.0f;
    if (k >= 1 && k < nb)
      gb[k] = (gp[2] * coeff(k, 2) + gp[1] * coeff(k, 1)) +
              gp[0] * coeff(k, 0);
  }

  // coefficients, over the row: g_sh[k, ch] = gp[ch] b_k below n_basis,
  // zero past it
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k <= A.n_rest)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        row[3 * k + ch] = k < nb ? gp[ch] * bas[k] : 0.0f;
  const float x = d.x, y = d.y, z = d.z;
  // sh_basis's products and their partials; basis values past n_basis
  // have a zero gradient and add nothing
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if (nb > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    // degree 2: b6 = C2[2] ((2 zz - xx) - yy), b8 = C2[4] (xx - yy)
    const float g6 = gb[6] * kC2[2], g8 = gb[8] * kC2[4];
    // degree 3: b = (C3[j] u) e with u one of x, y, z, xy and e a sum
    const float m9 = kC3[0] * y, e9 = 3.0f * xx - yy;
    const float m10 = kC3[1] * xy;
    const float m11 = kC3[2] * y, e11 = 4.0f * zz - xx - yy;
    const float m12 = kC3[3] * z, e12 = 2.0f * zz - 3.0f * xx - 3.0f * yy;
    const float m13 = kC3[4] * x, e13 = 4.0f * zz - xx - yy;
    const float m14 = kC3[5] * z, e14 = xx - yy;
    const float m15 = kC3[6] * x, e15 = xx - 3.0f * yy;
    const float ge9 = gb[9] * m9, ge11 = gb[11] * m11, ge12 = gb[12] * m12;
    const float ge13 = gb[13] * m13, ge14 = gb[14] * m14,
                ge15 = gb[15] * m15;
    // xx, yy, zz, xy, yz, xz: their consumers, the last created first
    const float g_xx = ((((((ge15 + ge14) + (-ge13)) + (-ge12) * 3.0f) +
                          (-ge11)) +
                         ge9 * 3.0f) +
                        g8) +
                       (-g6);
    const float g_yy = ((((((-ge15) * 3.0f + (-ge14)) + (-ge13)) +
                          (-ge12) * 3.0f) +
                         (-ge11)) +
                        (-ge9)) +
                       (-g8) + (-g6);
    const float g_zz = ((ge13 * 4.0f + ge12 * 2.0f) + ge11 * 4.0f) +
                       g6 * 2.0f;
    const float g_m10 = gb[10] * z;
    const float g_xy = g_m10 * kC3[1] + gb[4] * kC2[0];
    const float g_yz = gb[5] * kC2[1];
    const float g_xz = gb[7] * kC2[3];
    const float gb10z = gb[10] * m10;
    gx = (((((gb[15] * e15 * kC3[6] + gb[13] * e13 * kC3[4]) + g_xz * z) +
            g_xy * y) +
           g_xx * x) +
          g_xx * x) +
         gb[3] * (-kC1);
    gy = (((((gb[11] * e11 * kC3[2] + gb[9] * e9 * kC3[0]) + g_yz * z) +
            g_xy * x) +
           g_yy * y) +
          g_yy * y) +
         gb[1] * (-kC1);
    gz = ((((((gb[14] * e14 * kC3[5] + gb[12] * e12 * kC3[3]) + gb10z) +
             g_xz * x) +
            g_yz * y) +
           g_zz * z) +
          g_zz * z) +
         gb[2] * kC1;
  }
  // x = d0 inv_n (x, y, z made in that order), inv_n = reciprocal(len) 1,
  // len = sqrt(sq), sq = |d|^2 + 1e-18
  const float g_inv = (gz * d.d[2] + gy * d.d[1]) + gx * d.d[0];
  const float g_len = (-g_inv) * (d.inv_n * d.inv_n);
  const float g_sq = g_len / (2.0f * d.len);
  gd[0] = (gx * d.inv_n + g_sq * d.d[0]) + g_sq * d.d[0];
  gd[1] = (gy * d.inv_n + g_sq * d.d[1]) + g_sq * d.d[1];
  gd[2] = (gz * d.inv_n + g_sq * d.d[2]) + g_sq * d.d[2];
}

// One row's backward: the gradients of its means, scales and rotation, and
// with SH those of its coefficients over its staged row `row`.
__device__ __forceinline__ void row_backward(const ProjectArgs& A, int i,
                                             float* row) {
  const float* WV = A.world_view;
  const float* FP = A.full_proj;
  Geo g;
  geometry(A, i, g);
  const int64_t r = i;
  // Autograd's backward runs the plain version's nodes last-created first,
  // and a tensor with several consumers sums their gradients in that order:
  // each sum below is written in it.

  // conic = stack(c di, (-b) di, a di), di = reciprocal(det + 1e-12) 1
  const int64_t rc = A.gs_conic * r, rm = A.gs_mean2d * r;
  const float g0 = cot(A.g_conic, rc), g1 = cot(A.g_conic, rc + 1),
              g2 = cot(A.g_conic, rc + 2);
  const float g_di = (g2 * g.a + g1 * (-g.b)) + g0 * g.c;
  const float g_det = (-g_di) * (g.det_inv * g.det_inv);
  // det = a c - b b
  const float g_bb = -g_det;
  const float ga = g2 * g.det_inv + g_det * g.c;
  const float gb = ((-(g1 * g.det_inv)) + g_bb * g.b) + g_bb * g.b;
  const float gc = g0 * g.det_inv + g_det * g.a;

  // a = T0 . sT0 + 0.3, b = T0 . sT1, c = T1 . sT1 + 0.3 with
  // sT0 = (s0t0, s1t0, s2t0) = cov T0 and sT1 = cov T1
  const float* t0 = g.t0;
  const float* t1 = g.t1;
  const float cxx = g.cov[0], cxy = g.cov[1], cxz = g.cov[2];
  const float cyy = g.cov[3], cyz = g.cov[4], czz = g.cov[5];
  const float gs0t0 = ga * t0[0], gs1t0 = ga * t0[1], gs2t0 = ga * t0[2];
  const float gs0t1 = gc * t1[0] + gb * t0[0];
  const float gs1t1 = gc * t1[1] + gb * t0[1];
  const float gs2t1 = gc * t1[2] + gb * t0[2];
  const float gt00 =
      (((gb * g.s0t1 + ga * g.s0t0) + gs2t0 * cxz) + gs1t0 * cxy) +
      gs0t0 * cxx;
  const float gt01 =
      (((gb * g.s1t1 + ga * g.s1t0) + gs2t0 * cyz) + gs1t0 * cyy) +
      gs0t0 * cxy;
  const float gt02 =
      (((gb * g.s2t1 + ga * g.s2t0) + gs2t0 * czz) + gs1t0 * cyz) +
      gs0t0 * cxz;
  const float gt10 =
      ((gc * g.s0t1 + gs2t1 * cxz) + gs1t1 * cxy) + gs0t1 * cxx;
  const float gt11 =
      ((gc * g.s1t1 + gs2t1 * cyz) + gs1t1 * cyy) + gs0t1 * cxy;
  const float gt12 =
      ((gc * g.s2t1 + gs2t1 * czz) + gs1t1 * cyz) + gs0t1 * cxz;
  float gcov[6];
  gcov[0] = gs0t1 * t1[0] + gs0t0 * t0[0];
  gcov[1] = ((gs1t1 * t1[0] + gs0t1 * t1[1]) + gs1t0 * t0[0]) + gs0t0 * t0[1];
  gcov[2] = ((gs2t1 * t1[0] + gs0t1 * t1[2]) + gs2t0 * t0[0]) + gs0t0 * t0[2];
  gcov[3] = gs1t1 * t1[1] + gs1t0 * t0[1];
  gcov[4] = ((gs2t1 * t1[1] + gs1t1 * t1[2]) + gs2t0 * t0[1]) + gs1t0 * t0[2];
  gcov[5] = gs2t1 * t1[2] + gs2t0 * t0[2];

  // T0[k] = j00 W[k,0] + j02 W[k,2], T1[k] = j11 W[k,1] + j12 W[k,2]
  const float gj00 =
      (gt02 * at(WV, 2, 0) + gt01 * at(WV, 1, 0)) + gt00 * at(WV, 0, 0);
  const float gj02 =
      (gt02 * at(WV, 2, 2) + gt01 * at(WV, 1, 2)) + gt00 * at(WV, 0, 2);
  const float gj11 =
      (gt12 * at(WV, 2, 1) + gt11 * at(WV, 1, 1)) + gt10 * at(WV, 0, 1);
  const float gj12 =
      (gt12 * at(WV, 2, 2) + gt11 * at(WV, 1, 2)) + gt10 * at(WV, 0, 2);
  // j00 = fx inv_tz, j02 = (ex inv_tz) inv_tz with ex = -(fx txtz); in y
  const float g_exi = gj02 * g.inv_tz, g_eyi = gj12 * g.inv_tz;
  const float g_txtz = (-(g_exi * g.inv_tz)) * g.fx;
  const float g_tytz = (-(g_eyi * g.inv_tz)) * g.fy;
  const float g_inv =
      ((((gj12 * g.eyi + g_eyi * g.ey) + gj11 * g.fy) + gj02 * g.exi) +
       g_exi * g.ex) +
      gj00 * g.fx;
  // txtz = clamp(u) tz, u = tx / tz, the clamp's bounds inclusive; in y
  const float g_u =
      (g.u >= -g.limx && g.u <= g.limx) ? g_txtz * g.tz : 0.0f;
  const float g_v =
      (g.v >= -g.limy && g.v <= g.limy) ? g_tytz * g.tz : 0.0f;
  const float g_tx = g_u / g.tz, g_ty = g_v / g.tz;
  // tz's consumers: u, txtz, v, tytz, inv_tz = reciprocal(tz) 1, depth
  const float g_tz =
      ((((cot(A.g_depth, A.gs_depth * r) +
          (-g_inv) * (g.inv_tz * g.inv_tz)) +
         g_tytz * g.vc) +
        (-g_v) * (g.v / g.tz)) +
       g_txtz * g.uc) +
      (-g_u) * (g.u / g.tz);
  const float g_tzr = g.behind ? 0.0f : g_tz;

  // mean2d = ((h p_w + 1) S - 1) 0.5, p_w = reciprocal(hw + 1e-7) 1
  const float g2x = (cot(A.g_mean2d, rm) * 0.5f) * (float)A.width;
  const float g2y = (cot(A.g_mean2d, rm + 1) * 0.5f) * (float)A.height;
  const float g_hx = g2x * g.p_w, g_hy = g2y * g.p_w;
  const float g_pw = g2y * g.hy + g2x * g.hx;
  const float g_hw = (-g_pw) * (g.p_w * g.p_w);

  // the means: the colour's direction (made last), hw, hy, hx, tz, ty, tx
  float gm[3] = {0.0f, 0.0f, 0.0f};
  if (A.dc) sh_backward(A, i, row, gm);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    A.d_means[3 * r + k] =
        (((((gm[k] + g_hw * at(FP, k, 3)) + g_hy * at(FP, k, 1)) +
           g_hx * at(FP, k, 0)) +
          g_tzr * at(WV, k, 2)) +
         g_ty * at(WV, k, 1)) +
        g_tx * at(WV, k, 0);

  // compute_cov3d: entry e (xx, xy, xz, yy, yz, zz) of rows (p, q) sums
  // (S_k R[p][k]) R[q][k] over k
  float gR[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float gm1[6], cS[6], cRp[6], cRq[6];
    const int rows[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const float Rp = g.R[rows[e][0]][k], Rq = g.R[rows[e][1]][k];
      gm1[e] = gcov[e] * Rq;
      cRq[e] = gcov[e] * (g.S[k] * Rp);
      cS[e] = gm1[e] * Rp;
      cRp[e] = gm1[e] * g.S[k];
    }
    const float gS = ((((cS[5] + cS[4]) + cS[3]) + cS[2]) + cS[1]) + cS[0];
    // S_k = (sm s_k)^2
    A.d_scales[3 * r + k] = (gS * (2.0f * g.ss[k])) * A.scale_modifier;
    gR[0][k] = ((cRp[2] + cRp[1]) + cRq[0]) + cRp[0];
    gR[1][k] = ((cRp[4] + cRq[3]) + cRp[3]) + cRq[1];
    gR[2][k] = ((cRq[5] + cRp[5]) + cRq[4]) + cRq[2];
  }

  // R from the unit quaternion (w, x, y, z): r00 = 1 - 2 (y y + z z),
  // r01 = 2 (x y - w z), ... (compute_cov3d's order); gpq = the gradient
  // of the product (or sum) inside each entry's 2 (.)
  const float w = g.q[0], x = g.q[1], y = g.q[2], z = g.q[3];
  const float h00 = (-gR[0][0]) * 2.0f, h11 = (-gR[1][1]) * 2.0f,
              h22 = (-gR[2][2]) * 2.0f;
  const float h01 = gR[0][1] * 2.0f, h02 = gR[0][2] * 2.0f,
              h10 = gR[1][0] * 2.0f, h12 = gR[1][2] * 2.0f,
              h20 = gR[2][0] * 2.0f, h21 = gR[2][1] * 2.0f;
  float gq[4];
  gq[0] = ((((h21 * x + (-h20) * y) + (-h12) * x) + h10 * z) + h02 * y) +
          (-h01) * z;
  gq[1] = ((((((((h22 * x + h22 * x) + h21 * w) + h20 * z) + (-h12) * w) +
              h11 * x) +
             h11 * x) +
            h10 * y) +
           h02 * z) +
          h01 * y;
  gq[2] = ((((((((h22 * y + h22 * y) + h21 * z) + (-h20) * w) + h12 * z) +
              h10 * x) +
             h02 * w) +
            h01 * x) +
           h00 * y) +
          h00 * y;
  gq[3] = ((((((((h21 * y + h20 * x) + h12 * y) + h11 * z) + h11 * z) +
              h10 * w) +
             h02 * x) +
            (-h01) * w) +
           h00 * z) +
          h00 * z;
  // q = r / norm(r): the division's two gradients, the norm's after
  // (g (r / norm))
  float t[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) t[k] = (-gq[k]) * (g.q[k] / g.nr);
  const float g_n = sum4(t[0], t[1], t[2], t[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    A.d_rots[4 * r + k] = gq[k] / g.nr + g_n * (g.r[k] / g.nr);
}

__global__ void __launch_bounds__(kThreads)
    project_bwd_kernel(const __grid_constant__ ProjectArgs A) {
  __shared__ float sh[kThreads * kShStride];
  const int r0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, A.n - r0);
  if (A.dc) {
    stage_coeffs(A, r0, rows, sh);
    __syncthreads();
  }
  if (threadIdx.x < rows) row_backward(A, r0 + threadIdx.x,
                                       sh + threadIdx.x * kShStride);
  if (A.dc) {
    __syncthreads();
    store_coeff_grads(A, r0, rows, sh);
  }
}

bool valid_args(const ProjectArgs* a, int64_t bytes) {
  return a && bytes == (int64_t)sizeof(ProjectArgs) && a->n >= 0 &&
         a->n_rest >= 0 && a->n_basis >= 0 && a->n_basis <= 16 &&
         a->n_basis <= 1 + a->n_rest;
}

unsigned blocks(int n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// Returns a cudaError_t as int (0 on success).
extern "C" int trase_project_fwd(const ProjectArgs* args, int64_t bytes,
                                 void* stream) {
  if (!valid_args(args, bytes)) return (int)cudaErrorInvalidValue;
  if (args->n == 0) return 0;
  project_fwd_kernel<<<blocks(args->n), kThreads, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}

extern "C" int trase_project_bwd(const ProjectArgs* args, int64_t bytes,
                                 void* stream) {
  if (!valid_args(args, bytes)) return (int)cudaErrorInvalidValue;
  if (args->n == 0) return 0;
  project_bwd_kernel<<<blocks(args->n), kThreads, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
