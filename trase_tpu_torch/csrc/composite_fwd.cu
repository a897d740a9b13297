// Tile compositor, forward: the CUDA port of trase_tpu's Pallas kernel
// `_fwd_group_kernel` (trase_tpu/ops/rasterize_pallas.py:590), the one TPU
// kernel on the serving path (render of a trained scene).
//
// What it computes, per 16x16 pixel tile, front to back over the tile's
// depth-sorted (gaussian, tile) pairs [tile_start[t], tile_start[t+1]):
//   raw   = -1/2 (a dx^2 + c dy^2) - b dx dy + log(opacity)
//           dx, dy = tile-local mean - integer pixel coordinate (no +0.5)
//   alpha = exp(min(raw, log 0.99)), skipped (T unchanged) below 1/255
//   the pair counts while log T after it stays >= log 1e-4; the first pair
//   that would take it below stops the pixel and does not count
//   w     = exp(log alpha + log T),  acc += w,  v[c] += w * value[c]
// and writes [acc, v...] channels-last (H, W, 1 + NV) for in-image pixels.
// With WITH_RES (the training path) it also writes, for every pixel of the
// padded tile grid, the residuals the backward (composite_bwd.cu) reads:
// log T after the pixel's last contributing pair (the stop pair is not
// added) and the index, within the tile's pair range, of the pair that
// stopped it, or the range's length if none did. They are the per-pixel
// counterparts of `logt_out` / `stop_out` (rasterize_pallas.py:601-607),
// which the TPU keeps per tile and 128-pair window; per-pixel bookkeeping
// lets the backward decide which pairs counted by index alone.
// T is carried in LOG space, as the Pallas kernel does (its live test is
// `cum_incl + logt >= LOG_T_EPS`, rasterize_pallas.py:647), so the stop
// decision is the JAX one up to float reassociation. The plain PyTorch
// version (ops/rasterize_cuda.py: composite_plain) evaluates the same
// expressions in the same order; built with -fmad=false (no FMA
// contraction) the two agree to the last bits apart from libm ulps.
//
// Payload rows (one per gaussian, float32): [mx, my, a, b, c, log op | values]
// with values = NV floats [rgb 3, feats, depth 1], or, packed (NPACK > 0),
// [rgb 3, depth 1, NPACK words] where word r holds feats[r] as bf16 in its
// low half and feats[r + NPACK] in its high half (trase_tpu's
// pack_feature_rows layout; the bf16 pattern u16 is the float u16 << 16).
//
// Bound on one H100 SXM (3.35 TB/s, 67 TFLOP/s f32 non-tensor), at the
// serving path's scene (100k gaussians, 1008x1344, K=6):
//   bytes: each valid pair's payload row read once (40 B at NV=4, 168 B at
//   NV=36, 104 B packed) + its 4 B gaussian index, plus the HWC output
//   written once (5.4 MB per channel);
//   work: 16 f32 ops per evaluated pair-pixel (the splat quadratic, the
//   clamp and the skip test), 8 + 2 NV more per contributing one (2 exp,
//   1 log1p, the stop test, the accumulation), counting each
//   transcendental as one op.
//   chip_smoke.py reckons both from its run. There (H100 80GB HBM3, 700 W
//   power limit) the scene had 5.2e5 valid pairs, 1.21e8 evaluated and
//   1.00e8 contributing pair-pixels, so the work bound leads: 0.053 ms at
//   NV=4 (bytes 0.015 ms), 0.149 ms at NV=36 (bytes 0.086 ms; packed 0.077).
//
// This first design is simple and correct, not fast:
//   - one 256-thread block per tile, one thread per pixel; the block walks
//     its pair range in batches of 256: the gaussian ids are staged, then
//     the rows are copied cooperatively (consecutive threads read
//     consecutive words of a row) into shared memory (struct of arrays,
//     padded to avoid bank conflicts), then every thread composites the
//     batch front to back reading broadcast shared-memory words;
//   - the block leaves as soon as every pixel has stopped
//     (__syncthreads_count).
// Left for later work: deeper shared-memory batching with cp.async / TMA
// double buffering, warp-level culling of pairs that miss a warp's pixels,
// balancing long tile lists across blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block: one per pixel
constexpr int kBatch = kPix;         // pairs staged per shared-memory batch
constexpr int kGeom = 6;             // mean2d(2), conic(3), log opacity(1)

template <int NV, int NPACK, bool WITH_RES>
__global__ void __launch_bounds__(kPix)
composite_fwd_kernel(const float* __restrict__ payload,
                     const int* __restrict__ sorted_gauss,
                     const int* __restrict__ tile_start, int tw, int height,
                     int width, float log_alpha_max, float log_alpha_eps,
                     float log_t_eps, float* __restrict__ out,
                     float* __restrict__ res_logt,
                     int* __restrict__ res_stop) {
  static_assert(NPACK == 0 || NV == 4 + 2 * NPACK, "packed value layout");
  constexpr int kWords = kGeom + (NPACK > 0 ? 4 + NPACK : NV);
  __shared__ float rows[kWords][kBatch + 1];
  __shared__ int gid[kBatch];

  const int tile = blockIdx.x;
  const int tx = tile % tw;
  const int ty = tile / tw;
  const int lx = threadIdx.x % kTile;
  const int ly = threadIdx.x / kTile;
  const float fx = (float)lx;
  const float fy = (float)ly;
  const float ox = (float)(tx * kTile);
  const float oy = (float)(ty * kTile);
  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];

  float acc = 0.f;
  float val[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) val[c] = 0.f;
  float logt = 0.f;
  bool done = false;
  int stop = end;

  for (int base = start; base < end; base += kBatch) {
    // A barrier for the whole block: no thread still reads the previous
    // batch, and the block leaves once every pixel has stopped.
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(kBatch, end - base);
    if ((int)threadIdx.x < n) gid[threadIdx.x] = sorted_gauss[base + threadIdx.x];
    __syncthreads();
    for (int i = threadIdx.x; i < n * kWords; i += kPix) {
      const int j = i / kWords;
      const int c = i - j * kWords;
      rows[c][j] = payload[(size_t)gid[j] * kWords + c];
    }
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < n; ++j) {
      const float dx = (rows[0][j] - ox) - fx;
      const float dy = (rows[1][j] - oy) - fy;
      const float ca = rows[2][j];
      const float cb = rows[3][j];
      const float cc = rows[4][j];
      const float raw =
          -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy + rows[5][j];
      const float alog = fminf(raw, log_alpha_max);
      if (!(alog >= log_alpha_eps)) continue;  // alpha < 1/255: skipped
      const float alpha = expf(alog);
      const float next = logt + log1pf(-alpha);
      if (!(next >= log_t_eps)) {  // T would fall below 1e-4: stop here
        done = true;
        stop = base + j;
        break;
      }
      const float w = expf(alog + logt);
      acc += w;
      if constexpr (NPACK == 0) {
#pragma unroll
        for (int c = 0; c < NV; ++c) val[c] += w * rows[kGeom + c][j];
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) val[c] += w * rows[kGeom + c][j];
        val[NV - 1] += w * rows[kGeom + 3][j];
#pragma unroll
        for (int r = 0; r < NPACK; ++r) {
          const unsigned int u = __float_as_uint(rows[kGeom + 4 + r][j]);
          val[3 + r] += w * __uint_as_float(u << 16);
          val[3 + NPACK + r] += w * __uint_as_float(u & 0xffff0000u);
        }
      }
      logt = next;
    }
  }

  if constexpr (WITH_RES) {
    res_logt[(size_t)tile * kPix + threadIdx.x] = logt;
    res_stop[(size_t)tile * kPix + threadIdx.x] = stop - start;
  }
  const int px = tx * kTile + lx;
  const int py = ty * kTile + ly;
  if (px < width && py < height) {
    float* o = out + ((size_t)py * width + px) * (1 + NV);
    o[0] = acc;
#pragma unroll
    for (int c = 0; c < NV; ++c) o[1 + c] = val[c];
  }
}

template <int NV, int NPACK, bool WITH_RES>
int launch(const float* payload, const int* sorted_gauss,
           const int* tile_start, int num_tiles, int tw, int height,
           int width, float log_alpha_max, float log_alpha_eps,
           float log_t_eps, float* out, float* res_logt, int* res_stop,
           cudaStream_t stream) {
  composite_fwd_kernel<NV, NPACK, WITH_RES><<<num_tiles, kPix, 0, stream>>>(
      payload, sorted_gauss, tile_start, tw, height, width, log_alpha_max,
      log_alpha_eps, log_t_eps, out, res_logt, res_stop);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes. Returns the launch's cudaError_t (0 = success),
// or cudaErrorInvalidValue for a value layout without an instantiation.
// res_logt / res_stop (num_tiles * 256 each) are written when res_logt is
// not null; the residual instantiation exists for the rgb + depth layout
// that the GAUSSIAN training step composites.
extern "C" int trase_composite_fwd(const float* payload,
                                   const int* sorted_gauss,
                                   const int* tile_start, int num_tiles,
                                   int tw, int height, int width, int n_val,
                                   int n_packed, float log_alpha_max,
                                   float log_alpha_eps, float log_t_eps,
                                   float* out, float* res_logt,
                                   int* res_stop, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (num_tiles <= 0) return (int)cudaErrorInvalidValue;
  if (res_logt != nullptr) {
    if (n_val == 4 && n_packed == 0)
      return launch<4, 0, true>(payload, sorted_gauss, tile_start, num_tiles,
                                tw, height, width, log_alpha_max,
                                log_alpha_eps, log_t_eps, out, res_logt,
                                res_stop, s);
    return (int)cudaErrorInvalidValue;
  }
  if (n_val == 4 && n_packed == 0)
    return launch<4, 0, false>(payload, sorted_gauss, tile_start, num_tiles,
                               tw, height, width, log_alpha_max,
                               log_alpha_eps, log_t_eps, out, nullptr,
                               nullptr, s);
  if (n_val == 36 && n_packed == 0)
    return launch<36, 0, false>(payload, sorted_gauss, tile_start, num_tiles,
                                tw, height, width, log_alpha_max,
                                log_alpha_eps, log_t_eps, out, nullptr,
                                nullptr, s);
  if (n_val == 36 && n_packed == 16)
    return launch<36, 16, false>(payload, sorted_gauss, tile_start,
                                 num_tiles, tw, height, width, log_alpha_max,
                                 log_alpha_eps, log_t_eps, out, nullptr,
                                 nullptr, s);
  return (int)cudaErrorInvalidValue;
}
