// Tile compositor, forward: the CUDA port of trase_tpu's Pallas kernel
// `_fwd_group_kernel` (trase_tpu/ops/rasterize_pallas.py:590), on the
// serving path (render of a trained scene) and, with residuals, in both
// training steps.
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
// `cum_incl + logt >= LOG_T_EPS`, rasterize_pallas.py:647). The plain
// PyTorch version (ops/rasterize_cuda.py: composite_plain) evaluates the
// same expressions in the same order; built with -fmad=false (no FMA
// contraction) the two agree bit for bit, image and residuals.
//
// Payload rows (one per gaussian, float32): [mx, my, a, b, c, log op | values]
// with values = NV floats [rgb 3, feats, depth 1] (WITH_COLOR) or [feats]
// (the FEATURE phase's features-only layout, trase_tpu's with_color=False),
// or, packed (NPACK > 0), [rgb 3, depth 1, NPACK words] (WITH_COLOR) or
// [NPACK words] alone, where word r holds feats[r] as bf16 in its low half
// and feats[r + NPACK] in its high half (trase_tpu's pack_feature_rows
// layout; the bf16 pattern u16 is the float u16 << 16).
//
// Design (one block per tile):
//   - at 4 values each of 256 threads composites one pixel; at 32 and 36
//     values each of 128 threads composites 2 pixels of one column, on
//     consecutive rows, with the two pixels' exp / log1p / exp chains side
//     by side (the same expressions for both, selected after), so that
//     one thread has two independent chains in flight. The pair's loads,
//     dx, (a dx) dx, b dx and its values are taken once for both pixels:
//     C evaluates a dx dx as (a dx) dx and b dx dy as (b dx) dy, so
//     sharing them keeps each pixel's operations, and so its bits. At 4
//     values two pixels a thread saved too little (~2 of ~94 SASS
//     instructions per evaluated and contributing pair-pixel) to pay for
//     the warps it took away;
//   - the batch's rows are staged pair-major, [values | geometry] padded
//     to 16 bytes, so the lanes read a pair as 128-bit broadcasts: 3 loads
//     a pair at 4 values, 10 / 11 at 32 / 36 (the word-major rows of the
//     first design cost one 32-bit load a word). Packed rows are split
//     into float32 once per pair, by the thread that copied them, so the
//     loop is the same for packed and unpacked layouts;
//   - batches of one pair per thread, double-buffered: each thread copies
//     its pair's row by cp.async into one buffer while the block
//     composites the other, and loads the gaussian id of the batch after
//     that one ahead, so only the tile's first batch waits on its gathers;
//   - a thread leaves the batch once its pixels have stopped, the block
//     once every pixel has (__syncthreads_count), and at the end the
//     tile's [acc | values] go through shared memory, one PPT-th of the
//     pixels at a time, so that consecutive threads write consecutive
//     words of the image (a pixel's record is 1 + NV words: written per
//     thread, a warp's store touched 32 sectors).
//
// Bound on one H100 SXM (3.35 TB/s, 67 TFLOP/s f32 non-tensor, 132 SMs),
// at the serving path's scene (100k gaussians, 1008x1344, K=6):
//   bytes: each valid pair's payload row read once (40 B at NV=4, 168 B at
//   NV=36, 104 B packed) + its 4 B gaussian index, plus the HWC output
//   written once (5.4 MB per channel);
//   work: 16 f32 ops per evaluated pair-pixel (the splat quadratic, the
//   clamp and the skip test), 8 + 2 NV more per contributing one (2 exp,
//   1 log1p, the stop test, the accumulation), counting each
//   transcendental as one op. Operations lead, ~2-10x over the bytes.
// What paces the kernel is instruction issue, not the bound's arithmetic:
// the accurate expf, log1pf, expf chain the plain version pins (~60 SASS
// instructions a contributing pixel, two of them MUFU) and 2 NV more for
// the values (no fused multiply-add). chip_smoke.py counts the loop's
// SASS instructions per evaluated and per contributing pair-pixel and
// reckons from them an issue floor (4 warp-instructions per SM per clock)
// beside the bound; the kernel runs at ~1.4-1.5x that floor: lanes idle
// where a warp's pixels diverge (skipped, stopped) and the chain's
// latency is only partly hidden.
//
// Left for later: culling a pair for a whole warp (at the bench scene 83 %
// of evaluated pair-pixels contribute, so it would save little); splitting
// long tile lists across blocks; fewer transcendentals, with T carried as
// a product, which would change the expressions the plain version pins.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kGeom = 6;  // mean2d(2), conic(3), log opacity(1)

// Words of a layout, its launch shape and its dynamic shared memory. The
// rows the block composites are [NV values, in output order | geometry 6],
// padded to a multiple of 4 floats (the geometry starts 16-byte aligned).
// Unpacked layouts copy payload rows straight into them, two buffers of
// one row per thread; packed layouts copy the payload rows into two raw
// buffers and each thread then splits its row's bf16 words into the one
// buffer of rows the block composites.
template <int NV, int NPACK, bool WITH_COLOR>
struct FwdLayout {
  static constexpr int kPlain = WITH_COLOR ? 4 : 0;  // rgb + depth, packed
  static constexpr int kWords = kGeom + (NPACK > 0 ? kPlain + NPACK : NV);
  static constexpr int kStride = (NV + kGeom + 3) / 4 * 4;
  static constexpr int kPpt = NV <= 4 ? 1 : 2;  // pixels per thread
  static constexpr int kThreads = kPix / kPpt;
  static constexpr int kBatch = kThreads;  // pairs per staged batch
  static constexpr int kMinBlocks = NV <= 4 ? 6 : 4;
  static constexpr int kRowFloats = kBatch * kStride;
  static constexpr int kRawFloats = NPACK > 0 ? kBatch * kWords : 0;
  static constexpr int kStage =
      NPACK > 0 ? kRowFloats + 2 * kRawFloats : 2 * kRowFloats;
  // the write-out reuses the buffers: one PPT-th of the tile's records
  static constexpr int kOut = kThreads * (1 + NV);
  static constexpr size_t kSmem = sizeof(float) * (kStage > kOut ? kStage : kOut);
  static_assert(NV % 4 == 0, "values fill 16-byte groups");
  static_assert(kWords % 2 == 0, "rows copy in 8-byte pieces");
};

__device__ __forceinline__ void cp_async8(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of gaussian g's payload row into batch slot `slot`:
// unpacked, straight into the composited row (values first, then the
// geometry); packed, as it is into the raw row.
template <int NV, int NPACK, bool WITH_COLOR>
__device__ __forceinline__ void stage_row(float* smem, int slot, int t,
                                          const float* __restrict__ payload,
                                          int g) {
  using L = FwdLayout<NV, NPACK, WITH_COLOR>;
  const float* src = payload + (size_t)g * L::kWords;
  if constexpr (NPACK == 0) {
    float* row = smem + slot * L::kRowFloats + t * L::kStride;
#pragma unroll
    for (int c = 0; c < L::kWords; c += 2)
      cp_async8(row + (c < kGeom ? NV + c : c - kGeom), src + c);
  } else {
    float* raw = smem + L::kRowFloats + slot * L::kRawFloats + t * L::kWords;
#pragma unroll
    for (int c = 0; c < L::kWords; c += 2) cp_async8(raw + c, src + c);
  }
}

// Packed layouts: splits this thread's raw row of batch slot `slot` into
// its composited row, [rgb 3, feats 2 NPACK, depth | geometry] or
// [feats 2 NPACK | geometry]; word r's low half is feature r, its high
// half feature r + NPACK (the bf16 pattern u16 is the float u16 << 16).
template <int NV, int NPACK, bool WITH_COLOR>
__device__ __forceinline__ void unpack_row(float* smem, int slot, int t) {
  using L = FwdLayout<NV, NPACK, WITH_COLOR>;
  if constexpr (NPACK > 0) {
    const float* raw =
        smem + L::kRowFloats + slot * L::kRawFloats + t * L::kWords;
    float* row = smem + t * L::kStride;
    constexpr int kFeat0 = WITH_COLOR ? 3 : 0;
#pragma unroll
    for (int c = 0; c < kGeom; ++c) row[NV + c] = raw[c];
    if constexpr (WITH_COLOR) {
#pragma unroll
      for (int c = 0; c < 3; ++c) row[c] = raw[kGeom + c];
      row[NV - 1] = raw[kGeom + 3];
    }
#pragma unroll
    for (int r = 0; r < NPACK; ++r) {
      const unsigned int u = __float_as_uint(raw[kGeom + L::kPlain + r]);
      row[kFeat0 + r] = __uint_as_float(u << 16);
      row[kFeat0 + NPACK + r] = __uint_as_float(u & 0xffff0000u);
    }
  }
}

template <int NV, int NPACK, bool WITH_COLOR, bool WITH_RES>
__global__ void __launch_bounds__(
    (FwdLayout<NV, NPACK, WITH_COLOR>::kThreads),
    (FwdLayout<NV, NPACK, WITH_COLOR>::kMinBlocks))
composite_fwd_kernel(const float* __restrict__ payload,
                     const int* __restrict__ sorted_gauss,
                     const int* __restrict__ tile_start, int tw, int height,
                     int width, float log_alpha_max, float log_alpha_eps,
                     float log_t_eps, float* __restrict__ out,
                     float* __restrict__ res_logt,
                     int* __restrict__ res_stop) {
  using L = FwdLayout<NV, NPACK, WITH_COLOR>;
  static_assert(NPACK == 0 || NV == L::kPlain + 2 * NPACK,
                "packed value layout");
  constexpr int PPT = L::kPpt;
  constexpr int kThreads = L::kThreads;
  constexpr int kBatch = L::kBatch;
  constexpr int kStride = L::kStride;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int tx = tile % tw;
  const int ty = tile / tw;
  const int lx = t % kTile;
  const int ly0 = (t / kTile) * PPT;  // this thread's first pixel row
  const float fx = (float)lx;
  const float ox = (float)(tx * kTile);
  const float oy = (float)(ty * kTile);
  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];

  float acc[PPT], logt[PPT], val[PPT][NV];
  int stop[PPT];
  unsigned done = 0;  // bit p: pixel p has stopped
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    acc[p] = 0.f;
    logt[p] = 0.f;
    stop[p] = end;
#pragma unroll
    for (int c = 0; c < NV; ++c) val[p][c] = 0.f;
  }
  constexpr unsigned kAllDone = (1u << PPT) - 1u;

  // the first batch's rows, and the second batch's gaussian ids in flight
  int g_next = 0;
  if (start + t < end)
    stage_row<NV, NPACK, WITH_COLOR>(smem, 0, t, payload,
                                     sorted_gauss[start + t]);
  cp_async_commit();
  if (start + kBatch + t < end) g_next = sorted_gauss[start + kBatch + t];

  int k = 0;
  for (int base = start; base < end; base += kBatch, ++k) {
    // every thread is past the previous batch, so its buffers are free;
    // the block leaves once every pixel has stopped
    if (__syncthreads_count(done != kAllDone) == 0) break;
    const int next = base + kBatch;
    if (next + t < end)
      stage_row<NV, NPACK, WITH_COLOR>(smem, (k + 1) & 1, t, payload,
                                       g_next);
    cp_async_commit();
    if (next + kBatch + t < end) g_next = sorted_gauss[next + kBatch + t];
    cp_async_wait<1>();  // this thread's copies of batch k have landed
    if (base + t < end) unpack_row<NV, NPACK, WITH_COLOR>(smem, k & 1, t);
    __syncthreads();  // and every other thread's
    if (done == kAllDone) continue;
    const float* rows = smem + (NPACK > 0 ? 0 : (k & 1) * L::kRowFloats);
    const int n = min(kBatch, end - base);
    for (int j = 0; j < n; ++j) {
      const float* r = rows + j * kStride;
      const float4 ga = *reinterpret_cast<const float4*>(r + NV);
      const float2 gb = *reinterpret_cast<const float2*>(r + NV + 4);
      const float dx = (ga.x - ox) - fx;
      const float adxdx = ga.z * dx * dx;
      const float bdx = ga.w * dx;
      const float my = ga.y - oy;
      if constexpr (PPT == 1) {
        // one pixel: its chain, then its values as it contributes
        const float dy = my - (float)ly0;
        const float raw = -0.5f * (adxdx + gb.x * dy * dy) - bdx * dy + gb.y;
        const float alog = fminf(raw, log_alpha_max);
        if (!(alog >= log_alpha_eps)) continue;  // alpha < 1/255: skipped
        const float alpha = expf(alog);
        const float nxt = logt[0] + log1pf(-alpha);
        if (!(nxt >= log_t_eps)) {  // T would fall below 1e-4: stop here
          done = kAllDone;
          stop[0] = base + j;
          break;
        }
        const float w = expf(alog + logt[0]);
        acc[0] += w;
#pragma unroll
        for (int c4 = 0; c4 < NV / 4; ++c4) {
          const float4 v = reinterpret_cast<const float4*>(r)[c4];
          val[0][4 * c4] += w * v.x;
          val[0][4 * c4 + 1] += w * v.y;
          val[0][4 * c4 + 2] += w * v.z;
          val[0][4 * c4 + 3] += w * v.w;
        }
        logt[0] = nxt;
      } else {
        // the PPT pixels' chains side by side: the same expressions for
        // each, selected after (a pixel that is skipped or stopped
        // evaluates log(1/255)), then the values for all at once
        float alog[PPT], w[PPT];
        unsigned pass = 0;
#pragma unroll
        for (int p = 0; p < PPT; ++p) {
          w[p] = 0.f;
          const float dy = my - (float)(ly0 + p);
          const float raw =
              -0.5f * (adxdx + gb.x * dy * dy) - bdx * dy + gb.y;
          alog[p] = fminf(raw, log_alpha_max);
          if (!(done & (1u << p)) && alog[p] >= log_alpha_eps)
            pass |= 1u << p;
        }
        bool any = false;
        if (pass) {
          float nxt[PPT];
#pragma unroll
          for (int p = 0; p < PPT; ++p) {
            const float a = (pass & (1u << p)) ? alog[p] : log_alpha_eps;
            nxt[p] = logt[p] + log1pf(-expf(a));
          }
#pragma unroll
          for (int p = 0; p < PPT; ++p) {
            if ((pass & (1u << p)) && !(nxt[p] >= log_t_eps)) {
              pass &= ~(1u << p);
              done |= 1u << p;
              stop[p] = base + j;
            }
          }
          if (pass) {
#pragma unroll
            for (int p = 0; p < PPT; ++p) {
              const bool on = pass & (1u << p);
              const float e =
                  expf((on ? alog[p] : log_alpha_eps) + logt[p]);
              if (on) {
                w[p] = e;
                acc[p] += e;
                logt[p] = nxt[p];
              }
            }
            any = true;
          }
        }
        if (any) {  // w is 0 for the other pixels: adding w v keeps their bits
#pragma unroll
          for (int c4 = 0; c4 < NV / 4; ++c4) {
            const float4 v = reinterpret_cast<const float4*>(r)[c4];
#pragma unroll
            for (int p = 0; p < PPT; ++p) {
              val[p][4 * c4] += w[p] * v.x;
              val[p][4 * c4 + 1] += w[p] * v.y;
              val[p][4 * c4 + 2] += w[p] * v.z;
              val[p][4 * c4 + 3] += w[p] * v.w;
            }
          }
        }
        if (done == kAllDone) break;
      }
    }
  }
  cp_async_wait<0>();  // no copy may land after the buffers are reused

  if constexpr (WITH_RES) {
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const size_t i = (size_t)tile * kPix + (ly0 + p) * kTile + lx;
      res_logt[i] = logt[p];
      res_stop[i] = stop[p] - start;
    }
  }
  // the records of pixel row ly0 + p of every thread, then copied out one
  // pixel row at a time: consecutive threads write consecutive words
  constexpr int kRec = 1 + NV;
  const int seg = min(kTile, width - tx * kTile) * kRec;  // in-image words
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    __syncthreads();  // the buffers are free (first p) or copied out
    float* rec = smem + t * kRec;
    rec[0] = acc[p];
#pragma unroll
    for (int c = 0; c < NV; ++c) rec[1 + c] = val[p][c];
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kTile / PPT; ++rr) {  // thread row rr
      const int py = ty * kTile + rr * PPT + p;
      if (py >= height) break;
      float* dst = out + ((size_t)py * width + tx * kTile) * kRec;
      const float* src = smem + rr * kTile * kRec;
      for (int o = t; o < seg; o += kThreads) dst[o] = src[o];
    }
  }
}

template <int NV, int NPACK, bool WITH_COLOR, bool WITH_RES>
int launch(const float* payload, const int* sorted_gauss,
           const int* tile_start, int num_tiles, int tw, int height,
           int width, float log_alpha_max, float log_alpha_eps,
           float log_t_eps, float* out, float* res_logt, int* res_stop,
           cudaStream_t stream) {
  using L = FwdLayout<NV, NPACK, WITH_COLOR>;
  auto kernel = composite_fwd_kernel<NV, NPACK, WITH_COLOR, WITH_RES>;
  const int bytes = (int)L::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_tiles, L::kThreads, bytes, stream>>>(
      payload, sorted_gauss, tile_start, tw, height, width, log_alpha_max,
      log_alpha_eps, log_t_eps, out, res_logt, res_stop);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes. Returns the launch's cudaError_t (0 = success),
// cudaErrorInvalidValue for a value layout without an instantiation, or
// cudaErrorMisalignedAddress for a payload that is not 8-byte aligned (rows
// are copied 8 bytes at a time). res_logt / res_stop (num_tiles * 256 each)
// are written when res_logt is not null; the residual instantiations exist
// for the layouts the training steps composite: rgb + depth (GAUSSIAN) and
// 32 features alone, unpacked or packed (FEATURE).
extern "C" int trase_composite_fwd(const float* payload,
                                   const int* sorted_gauss,
                                   const int* tile_start, int num_tiles,
                                   int tw, int height, int width, int n_val,
                                   int n_packed, int with_color,
                                   float log_alpha_max, float log_alpha_eps,
                                   float log_t_eps, float* out,
                                   float* res_logt, int* res_stop,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (num_tiles <= 0) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)payload % 8) return (int)cudaErrorMisalignedAddress;
  const bool res = res_logt != nullptr;
#define TRASE_FWD(NV, NPACK, COLOR, RES)                                   \
  if (n_val == NV && n_packed == NPACK && (with_color != 0) == COLOR &&  \
      res == RES)                                                          \
    return launch<NV, NPACK, COLOR, RES>(                                  \
        payload, sorted_gauss, tile_start, num_tiles, tw, height, width,   \
        log_alpha_max, log_alpha_eps, log_t_eps, out, res_logt, res_stop,  \
        s);
  TRASE_FWD(4, 0, true, true)
  TRASE_FWD(32, 0, false, true)
  TRASE_FWD(32, 16, false, true)
  TRASE_FWD(4, 0, true, false)
  TRASE_FWD(36, 0, true, false)
  TRASE_FWD(36, 16, true, false)
  TRASE_FWD(32, 0, false, false)
  TRASE_FWD(32, 16, false, false)
#undef TRASE_FWD
  return (int)cudaErrorInvalidValue;
}
