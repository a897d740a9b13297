// Tile compositor, backward, and the per-gaussian reduction of its pair
// gradients: the CUDA port of trase_tpu's Pallas kernels `_bwd_group_kernel`
// (trase_tpu/ops/rasterize_pallas.py:817) and `_transpose_kernel` (:1195)
// with the un-sort it feeds (`unsort_slot_gradients`, :1355). They carry the
// gradient of both training steps: GAUSSIAN (rgb + depth) and FEATURE (32
// features alone, unpacked or bf16-packed, full or values-only).
//
// 1. composite_bwd_kernel: one 256-thread block per 16x16 tile, one thread
//    per pixel. The forward (composite_fwd.cu, WITH_RES) left per pixel
//    log T after its last contributing pair and its stop index s_p within
//    the tile's pair range. The block walks the tile's pairs back to front
//    from the largest s_p in the tile, in shared-memory batches as the
//    forward does. Pair j counts for pixel p iff j < s_p and
//    alog = min(raw, log 0.99) >= log(1/255): exactly the pairs the forward
//    added, decided by the stored index rather than by a second log-space
//    test, so the two walks cannot disagree (the hazard that
//    `test_zombie_window_grads` pins on the TPU). For each counted pair, in
//    reverse, with g the pixel's cotangent [g_acc, g_values]:
//      log T_before = log T_after - log1p(-alpha),  T = exp(log T_before)
//      w      = alpha T
//      q      = g_acc + sum_c g_c v_c
//      dalpha = q T - R / (1 - alpha),  R = sum of q w over later counted pairs
//      dpow   = dalpha alpha where raw < log 0.99, else 0
//      d mean = dpow (-(a dx + b dy), -(c dy + b dx)),
//      d conic = dpow (-dx^2 / 2, -dx dy, -dy^2 / 2),  d log op = dpow,
//      d v_c  = g_c w
//    (dx, dy = tile-local mean - integer pixel coordinate, as the forward).
//    The 6 + NV words of each pair are summed over the block's 256 pixels:
//    xor-shuffles inside each warp (skipped when no lane of the warp counts
//    the pair), then one pass over the 8 warps' partials in shared memory,
//    in warp order. Row i of dpair (n_pairs, 6 + NV) is the pair at sorted
//    position i. No float atomics: the result is the same run to run.
//    Rows of the tile's range at or past its largest stop get zeros (the
//    stop pair and every later one have no gradient); rows of invalid
//    pairs, past tile_start[num_tiles], are not written.
//    In VALUES_ONLY mode (the FEATURE step once densification has ended:
//    trase_tpu's values_only, rasterize_pallas.py:938-948) the kernel emits
//    d v_c = g_c w alone and exact zeros in the 6 geometry words: it still
//    reconstructs each pair's alpha and the reverse log T, but skips q, the
//    suffix R, dalpha and the chain. The value words are the same
//    expressions summed in the same order as the full mode's, so the two
//    modes agree on them bit for bit.
// 2. reduce_pair_grads_kernel: one thread per (gaussian g, word). It sums,
//    in k order, the rows at sorted positions inv[g K + k] (inv is the
//    inverse of the sort's permutation), reading 0 for positions at or past
//    tile_start[num_tiles] (the invalid-pair sentinel: the TPU's win_range
//    mask), and writes the (N, 6 + NV) per-gaussian payload gradient.
//
// Payload layouts (as the forward reads them, composite_fwd.cu): values
// [rgb 3, feats, depth] or features alone (WITH_COLOR false), unpacked, or
// with the features bf16-packed two per word (NPACK > 0). The gradient row
// is always unpacked, 6 + NV words: a packed payload row (6 + 16 words for
// the features-only layout) is narrower than its gradient row (6 + 32).
//
// Bound on one H100 SXM (3.35 TB/s, 67 TFLOP/s f32 non-tensor):
//   backward bytes: each valid pair's payload row (4 x its words) and
//   gaussian index (4 B) read once, its gradient row (4 (6 + NV) B) written
//   once, the cotangent (4 (1 + NV) B per pixel) and residuals (8 B per
//   padded pixel) read once;
//   backward work: 16 f32 ops per evaluated pair-pixel (pair below the
//   tile's largest stop: the splat quadratic, clamp, tests), 35 + 4 NV per
//   counted pair-pixel (3 transcendentals counted as one op each, q, dalpha,
//   the suffix, the chain, d v, and its share of the 256-pixel sums), or
//   5 + 2 NV in VALUES_ONLY mode (alpha, log T, w, d v and its sums);
//   reduce bytes: inv (4 B per pair), each valid gradient row once, the
//   output once; work: K (6 + NV) adds per gaussian, so bytes bound it.
//   chip_smoke.py reckons both bounds from its run's counts.
//
// This first design is simple and correct, not fast: the reduction costs
// (6 + NV) x 5 shuffles per pair per warp that the pair touches (38 x 5 at
// the FEATURE layouts), and long tile lists leave SMs idle at the tail, as
// in the forward. Shared memory is static: pair rows staged per batch plus
// the 8 warps' partial sums, part[8][batch][6 + NV]. At 38 gradient words
// a 64-pair batch would need 88.0 KB, over the 48 KB static limit, so the
// wide layouts stage 32 pairs per batch (44.1 KB unpacked, 42.0 KB packed)
// and the 10-word GAUSSIAN layout keeps 64.
//
// Built with -fmad=false, like the forward, so that the plain PyTorch
// versions (ops/rasterize_cuda.py: composite_bwd_plain,
// reduce_pair_grads_plain) evaluate the same per-pixel expressions to the
// last bit; only the order of the 256-pixel sums differs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block: one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kGeom = 6;             // mean2d(2), conic(3), log opacity(1)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// Unpacked value c of staged pair j: rows is word-major with stride ld.
// c is a compile-time constant in the unrolled loops, so the branches fold.
template <int NV, int NPACK, bool WITH_COLOR>
__device__ __forceinline__ float value_at(const float* rows, int ld, int c,
                                          int j) {
  if constexpr (NPACK == 0) {
    return rows[(kGeom + c) * ld + j];
  } else {
    constexpr int kFeat0 = WITH_COLOR ? 3 : 0;  // first feature value
    constexpr int kWord0 = kGeom + (WITH_COLOR ? 4 : 0);  // first packed word
    if (WITH_COLOR && c < 3) return rows[(kGeom + c) * ld + j];
    if (WITH_COLOR && c == NV - 1) return rows[(kGeom + 3) * ld + j];
    const int f = c - kFeat0;
    const unsigned int u = __float_as_uint(
        rows[(kWord0 + (f < NPACK ? f : f - NPACK)) * ld + j]);
    return __uint_as_float(f < NPACK ? u << 16 : u & 0xffff0000u);
  }
}

template <int NV, int NPACK, bool WITH_COLOR, bool VALUES_ONLY>
__global__ void __launch_bounds__(kPix)
composite_bwd_kernel(const float* __restrict__ payload,
                     const int* __restrict__ sorted_gauss,
                     const int* __restrict__ tile_start, int tw, int height,
                     int width, const float* __restrict__ grad_out,
                     const float* __restrict__ res_logt,
                     const int* __restrict__ res_stop, float log_alpha_max,
                     float log_alpha_eps, float* __restrict__ dpair,
                     float* __restrict__ logt_first) {
  constexpr int kPlain = WITH_COLOR ? 4 : 0;
  static_assert(NPACK == 0 || NV == kPlain + 2 * NPACK,
                "packed value layout");
  constexpr int kPayWords = kGeom + (NPACK > 0 ? kPlain + NPACK : NV);
  constexpr int kWords = kGeom + NV;  // gradient row, always unpacked
  constexpr int kBatch = kWords > 16 ? 32 : 64;  // pairs staged per batch
  constexpr int kLd = kBatch + 1;
  __shared__ float rows[kPayWords * kLd];
  __shared__ float part[kWarps][kBatch][kWords];
  __shared__ int gid[kBatch];
  __shared__ int warp_max[kWarps];

  const int tile = blockIdx.x;
  const int tx = tile % tw;
  const int ty = tile / tw;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lx = threadIdx.x % kTile;
  const int ly = threadIdx.x / kTile;
  const float fx = (float)lx;
  const float fy = (float)ly;
  const float ox = (float)(tx * kTile);
  const float oy = (float)(ty * kTile);
  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];

  const int px = tx * kTile + lx;
  const int py = ty * kTile + ly;
  float g[1 + NV];
  if (px < width && py < height) {
    const float* gp = grad_out + ((size_t)py * width + px) * (1 + NV);
#pragma unroll
    for (int c = 0; c < 1 + NV; ++c) g[c] = gp[c];
  } else {
#pragma unroll
    for (int c = 0; c < 1 + NV; ++c) g[c] = 0.f;
  }
  float logt = res_logt[(size_t)tile * kPix + threadIdx.x];
  const int my_stop = res_stop[(size_t)tile * kPix + threadIdx.x];
  float suffix = 0.f;

  int m = __reduce_max_sync(kFull, my_stop);
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  int max_stop = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) max_stop = max(max_stop, warp_max[w]);

  // the stop pairs and every later pair of the range: no gradient
  for (int i = max_stop * kWords + threadIdx.x; i < (end - start) * kWords;
       i += kPix)
    dpair[(size_t)start * kWords + i] = 0.f;

  for (int hi = max_stop; hi > 0; hi -= kBatch) {
    const int lo = max(hi - kBatch, 0);
    const int n = hi - lo;
    __syncthreads();  // the previous batch's rows and partials are read
    if ((int)threadIdx.x < n) gid[threadIdx.x] = sorted_gauss[start + lo + threadIdx.x];
    __syncthreads();
    for (int i = threadIdx.x; i < n * kPayWords; i += kPix) {
      const int j = i / kPayWords;
      const int c = i - j * kPayWords;
      rows[c * kLd + j] = payload[(size_t)gid[j] * kPayWords + c];
    }
    __syncthreads();
    for (int j = n - 1; j >= 0; --j) {
      const float dx = (rows[0 * kLd + j] - ox) - fx;
      const float dy = (rows[1 * kLd + j] - oy) - fy;
      const float ca = rows[2 * kLd + j];
      const float cb = rows[3 * kLd + j];
      const float cc = rows[4 * kLd + j];
      const float raw = -0.5f * (ca * dx * dx + cc * dy * dy) -
                        cb * dx * dy + rows[5 * kLd + j];
      const float alog = fminf(raw, log_alpha_max);
      const bool counted = (lo + j < my_stop) && (alog >= log_alpha_eps);
      float d[kWords];
#pragma unroll
      for (int c = 0; c < kWords; ++c) d[c] = 0.f;
      if (counted) {
        const float alpha = expf(alog);
        const float before = logt - log1pf(-alpha);
        const float t = expf(before);
        const float w = alpha * t;
        if constexpr (!VALUES_ONLY) {
          float q = g[0];
#pragma unroll
          for (int c = 0; c < NV; ++c)
            q += g[1 + c] * value_at<NV, NPACK, WITH_COLOR>(rows, kLd, c, j);
          const float dalpha = q * t - suffix / (1.f - alpha);
          suffix += q * w;
          const float dpow = raw < log_alpha_max ? dalpha * alpha : 0.f;
          d[0] = dpow * -(ca * dx + cb * dy);
          d[1] = dpow * -(cc * dy + cb * dx);
          d[2] = dpow * (-0.5f * dx * dx);
          d[3] = dpow * -(dx * dy);
          d[4] = dpow * (-0.5f * dy * dy);
          d[5] = dpow;
        }
        logt = before;
#pragma unroll
        for (int c = 0; c < NV; ++c) d[kGeom + c] = g[1 + c] * w;
      }
      constexpr int kFirst = VALUES_ONLY ? kGeom : 0;  // words summed
      if (__any_sync(kFull, counted)) {
#pragma unroll
        for (int c = kFirst; c < kWords; ++c) {
          const float s = warp_sum(d[c]);
          if (lane == (c & 31)) part[warp][j][c] = s;
        }
      } else {
        for (int c = kFirst + lane; c < kWords; c += 32)
          part[warp][j][c] = 0.f;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * kWords; i += kPix) {
      const int j = i / kWords;
      const int c = i - j * kWords;
      float s = 0.f;
      if (!VALUES_ONLY || c >= kGeom) {
        s = part[0][j][c];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += part[w][j][c];
      }
      dpair[(size_t)(start + lo + j) * kWords + c] = s;
    }
  }
  if (logt_first != nullptr)
    logt_first[(size_t)tile * kPix + threadIdx.x] = logt;
}

__global__ void reduce_pair_grads_kernel(const float* __restrict__ dpair,
                                         const int* __restrict__ inv,
                                         const int* __restrict__ n_valid_at,
                                         int n, int k, int words,
                                         float* __restrict__ dpayload) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)n * words) return;
  const int64_t gauss = i / words;
  const int c = (int)(i - gauss * words);
  const int n_valid = *n_valid_at;
  float s = 0.f;
  for (int r = 0; r < k; ++r) {
    const int pos = inv[gauss * k + r];
    s += pos < n_valid ? dpair[(size_t)pos * words + c] : 0.f;
  }
  dpayload[i] = s;
}

}  // namespace

// C interfaces for ctypes. Each returns the launch's cudaError_t
// (0 = success), or cudaErrorInvalidValue for a value layout without an
// instantiation. logt_first (num_tiles * 256) is optional: when not null it
// receives each pixel's log T reconstructed back to the tile's first pair,
// which is 0 up to rounding (a check of the reverse walk).
extern "C" int trase_composite_bwd(const float* payload,
                                   const int* sorted_gauss,
                                   const int* tile_start, int num_tiles,
                                   int tw, int height, int width, int n_val,
                                   int n_packed, int with_color,
                                   int values_only, const float* grad_out,
                                   const float* res_logt, const int* res_stop,
                                   float log_alpha_max, float log_alpha_eps,
                                   float* dpair, float* logt_first,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (num_tiles <= 0) return (int)cudaErrorInvalidValue;
#define TRASE_BWD(NV, NPACK, COLOR, VONLY)                                 \
  if (n_val == NV && n_packed == NPACK && (with_color != 0) == COLOR &&  \
      (values_only != 0) == VONLY) {                                       \
    composite_bwd_kernel<NV, NPACK, COLOR, VONLY><<<num_tiles, kPix, 0, s>>>( \
        payload, sorted_gauss, tile_start, tw, height, width, grad_out,    \
        res_logt, res_stop, log_alpha_max, log_alpha_eps, dpair,           \
        logt_first);                                                       \
    return (int)cudaGetLastError();                                        \
  }
  TRASE_BWD(4, 0, true, false)
  TRASE_BWD(32, 0, false, false)
  TRASE_BWD(32, 0, false, true)
  TRASE_BWD(32, 16, false, false)
  TRASE_BWD(32, 16, false, true)
#undef TRASE_BWD
  return (int)cudaErrorInvalidValue;
}

// n_valid_at points at tile_start[num_tiles] on the device (no host sync).
extern "C" int trase_reduce_pair_grads(const float* dpair, const int* inv,
                                       const int* n_valid_at, int n, int k,
                                       int words, float* dpayload,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = (int64_t)n * words;
  if (total <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  reduce_pair_grads_kernel<<<blocks, threads, 0, s>>>(dpair, inv, n_valid_at,
                                                      n, k, words, dpayload);
  return (int)cudaGetLastError();
}
