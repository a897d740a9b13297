// Tile compositor, backward, and the per-gaussian reduction of its pair
// gradients: the CUDA port of trase_tpu's Pallas kernels `_bwd_group_kernel`
// (trase_tpu/ops/rasterize_pallas.py:817) and `_transpose_kernel` (:1195)
// with the un-sort it feeds (`unsort_slot_gradients`, :1355). They carry the
// gradient of both training steps, GAUSSIAN (rgb + depth) and FEATURE (32
// features alone, unpacked or bf16-packed), and of every other layout the
// forward composites (rgb + depth beside 32 features, unpacked or packed),
// each full or values-only, as trase_tpu differentiates any value layout.
//
// 1. composite_bwd_kernel: one 256-thread block per 16x16 tile, one thread
//    per pixel. The forward (composite_fwd.cu, WITH_RES) left per pixel
//    log T after its last contributing pair and its stop index s_p within
//    the tile's pair range. The block walks the tile's pairs back to front
//    from the largest s_p in the tile, in shared-memory batches of 64 pairs.
//    Pair j counts for pixel p iff j < s_p and
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
//    The 6 + NV words of each pair are summed over the block's 256 pixels in
//    two stages, in a fixed order (no float atomics: the result is the same
//    run to run):
//    - inside each warp, as products over its 32 pixels, taken every 8
//      pairs from what each pixel wrote to shared memory for them (its w
//      and dpow), not per pair. The 32 feature words: lane c sums
//      w_p g_c,p over p in pixel order by fused multiply-adds, g_c of the
//      warp's pixels held in its registers (32 + 8 vector loads per pair,
//      against 32 products and a 31-shuffle butterfly with two selects per
//      step and word). The 6 geometry words through the monomial basis of
//      trase_tpu's kernel (rasterize_pallas.py:958-971): 4 lanes per pair,
//      each over 8 pixels of one pixel row, sum dpow, dpow u and dpow u^2
//      (u, v: the pixel's offsets from the tile's centre), two xor steps
//      add the 4 with v dpow, v dpow u and v^2 dpow formed per row, and
//      with dx = mx' - u, dy = my' - v (mx', my': the mean's offsets from
//      the centre) each word is a combination of the six moments, e.g.
//      sum dpow dx^2 = mx'^2 S - 2 mx' S_u + S_uu. rgb + depth (value
//      columns 0-2 and the last) ride along in the same lanes: each sums
//      w g_c over its 8 pixels (g_c from a per-warp copy in shared
//      memory), and the same two xor steps add them. Per 8 pairs and warp
//      that is 12 (20 with rgb + depth) shuffles, where a warp-wide
//      all-reduce per word and pair took 5 x words: 190 at 38 words, 50
//      at 10. A layout with colour and features (42 words: rgb 3,
//      features 32, depth) takes both: the features by the products
//      (lane c, value column 3 + c), rgb + depth beside the moments;
//    - the 8 warps' partials, staged in shared memory, summed in warp order.
//    The per-pixel expressions are the plain version's (-fmad=false) up to
//    w and dpow. The products do not round g_c w before they add it, the
//    moments expand (mx' - u)^2 and the like, so they cancel where the
//    mean lies near the tile's centre (centring keeps u, v, mx', my' and
//    the terms small), and the 256-pixel sums run in another order: all
//    far inside chip_smoke.py's tolerance (1e-4 of each column group's
//    largest magnitude).
//    A warp skips the arithmetic of every pair at or past its own largest
//    stop, and the sums of every pair none of its lanes counts: it writes
//    zero partials for them. Row i of dpair (n_pairs, 6 + NV) is the pair at
//    sorted position i. Rows of the tile's range at or past its largest stop
//    get zeros (the stop pair and every later one have no gradient); rows of
//    invalid pairs, past tile_start[num_tiles], are not written.
//    Blocks take the tiles in tile order. Longest walk first ran the kernel
//    4-10 % faster on the H100, but the sort it needs before each launch
//    cost about as much device time and doubled the wrapper's host time.
//    In VALUES_ONLY mode (the FEATURE step once densification has ended:
//    trase_tpu's values_only, rasterize_pallas.py:938-948) the kernel emits
//    d v_c = g_c w alone and exact zeros in the 6 geometry words: it still
//    reconstructs each pair's alpha and the reverse log T, but skips q, the
//    suffix R, dalpha and the chain; with colour its moment lanes sum
//    rgb + depth alone. The value words are the same expressions summed
//    in the same order as the full mode's, so the two modes agree on them
//    bit for bit.
// 2. reduce_pair_grads_kernel: one warp per few gaussians. The lanes that
//    hold a gaussian's K sorted positions inv[g K + k] (inv is the inverse
//    of the sort's permutation) load them once, one lane each, and broadcast
//    them by shuffles; words / 2 lanes per gaussian then sum its rows a
//    float2 each, in k order, reading 0 for positions outside the pair
//    range [lo, hi) (the TPU's win_range mask: for the whole image [0,
//    tile_start[num_tiles]), which leaves out the invalid pairs), and write
//    the (N, 6 + NV) per-gaussian payload gradient. The lane that loads a
//    position tests it against the range once, before it is shuffled to
//    the lanes that read the row. The sums are the plain version's, in its
//    order: bit for bit.
// Slab mode (the multi-device steps, trase_tpu_torch/parallel): the
//    backward walks a slab of whole tile rows, given as the forward's slab
//    is (its own tile_start, cotangent rows and residuals, and its first
//    tile row ty0, from which alone the splat's origin is taken), and so
//    writes its own pairs' rows only; the reduce then sums the slab's pair
//    range [tile_start[t_lo], tile_start[t_hi]) alone, so the ranks'
//    partial payload gradients sum to the whole image's. Counterpart of
//    `g_lo` / `rows_local` in `_backward_impl` (rasterize_pallas.py:
//    1095-1119) and of `win_range` in `_transpose_slots` (:1222-1259).
//    The whole image is the slab of every tile: one backward
//    instantiation serves both. The slab's reduce walks the slab's own
//    pairs (reduce_slab_pairs_kernel): reduce_pair_grads_kernel over a
//    slab's range reads every gaussian's K positions and writes every
//    row, so each of 4 slabs cost 0.85-0.9 of the whole image's reduce;
//    the walk costs a slab 0.4-0.6 of it at 38 words, and as much as
//    reduce_pair_grads_kernel over the range at 10.
//
// Payload layouts (as the forward reads them, composite_fwd.cu): values
// [rgb 3, depth], [rgb 3, features 32, depth] or the features alone
// (WITH_COLOR false), the features unpacked or bf16-packed two per word
// (NPACK > 0; with colour the payload row is [geom | rgb 3, depth, 16
// words]). The gradient row is always unpacked, 6 + NV words in value
// column order: a packed payload row (6 + 16 or 6 + 20 words) is narrower
// than its gradient row (38 or 42).
//
// Bound on one H100 SXM (3.35 TB/s, 67 TFLOP/s f32 non-tensor, 132 SMs):
//   backward bytes: each valid pair's payload row (4 x its words) and
//   gaussian index (4 B) read once, its gradient row (4 (6 + NV) B) written
//   once, the cotangent (4 (1 + NV) B per pixel) and residuals (8 B per
//   padded pixel) read once;
//   backward work: 16 f32 ops per evaluated pair-pixel (pair below the
//   tile's largest stop: the splat quadratic, clamp, tests), 35 + 4 NV per
//   counted pair-pixel (3 transcendentals counted as one op each, q, dalpha,
//   the suffix, the chain, d v, and its share of the 256-pixel sums), or
//   5 + 2 NV in VALUES_ONLY mode (alpha, log T, w, d v and its sums). So
//   operations bound it, about 10x over its bytes. Besides the bound, the
//   card shuffles one warp-wide word per SM per clock. The shuffles left
//   are the geometry moments' two xor steps (12 words, 20 with rgb +
//   depth) in every 8-pair sub-batch and warp below the tile's largest
//   stop; chip_smoke.py reckons their floor beside the time (a warp-wide
//   all-reduce per word and pair, the design the products replaced, put
//   it at 60-70 % of the kernel's time);
//   reduce bytes: inv (4 B per pair), each valid gradient row once, the
//   output once; work: K (6 + NV) adds per gaussian, so bytes bound it. A
//   slab's: its pairs' gaussians and rows, the output once;
//   chip_smoke.py reckons both bounds from its run's counts.
//
// Shared memory is dynamic (cudaFuncSetAttribute at each launch): the 8
// warps' partials part[8][64][6 + NV], the batch's payload rows staged
// unpacked (bf16 features split once per pair, not once per warp) and
// pair-major, [values | geometry] padded to 16 bytes, so that the lanes
// read a pair's words as 128-bit broadcasts (8 + 2 loads for q and the
// geometry at 38 words, in place of 38), and each warp's w and dpow of 8
// pairs: 44,320 B for the 10-word layout, 104,736 B for the 38-word ones
// (96,544 B values-only), so two blocks fit on an SM; 118,048 B at 42
// words (109,856 B values-only): one block (two). The launch bounds ask
// for two blocks of 256 threads per SM (at most 128 registers) at 38
// words and four (64) at 10: more blocks hide the 10-word walk's latency
// better than more registers would (three blocks at 80 registers measured
// 7 % slower on the H100). The 42-word full mode asks for one: its 37
// cotangents and 32 product terms per thread do not fit 128 registers
// beside the rest. ptxas (-Xptxas -v, sm_90a): 127 registers at 38 words
// full, 90-94 values-only, 64 at 10 words, 40 for the reduce; no spills,
// no stack frame (chip_smoke.py reads every instantiation's registers and
// spill bytes with cuobjdump and fails on a spill).
//
// Built with -fmad=false, like the forward, so that the plain PyTorch
// versions (ops/rasterize_cuda.py: composite_bwd_plain,
// reduce_pair_grads_plain) evaluate the same per-pixel expressions to the
// last bit, up to the sums above.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block: one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kGeom = 6;             // mean2d(2), conic(3), log opacity(1)
constexpr int kBatch = 64;           // pairs staged per batch
constexpr int kSub = 8;              // pairs per product sub-batch
constexpr unsigned kFull = 0xffffffffu;

// Stages payload word cw of one pair unpacked into its staged row:
// [values NV | geometry 6]. Packed layouts (NPACK > 0) carry bf16 features
// two per payload word, feature f in the low half of word f and feature
// f + NPACK in the high half, after rgb + depth where there is colour
// (payload [geom 6 | rgb 3, depth, NPACK words], staged [rgb 3, features
// 2 NPACK, depth | geom 6], the forward's order).
template <int NV, int NPACK, bool WITH_COLOR>
__device__ __forceinline__ void stage_word(float* row, int cw, float word) {
  if (cw < kGeom) {
    row[NV + cw] = word;
  } else if constexpr (NPACK == 0) {
    row[cw - kGeom] = word;
  } else {
    constexpr int kPlain = WITH_COLOR ? 4 : 0;  // rgb + depth, unpacked
    const int r = cw - kGeom;
    if (r < kPlain) {
      row[r < 3 ? r : NV - 1] = word;
    } else {
      const int f = (WITH_COLOR ? 3 : 0) + r - kPlain;
      const unsigned int u = __float_as_uint(word);
      row[f] = __uint_as_float(u << 16);
      row[f + NPACK] = __uint_as_float(u & 0xffff0000u);
    }
  }
}

// Words of a layout, how its sums are taken, and its dynamic shared
// memory: wbuf and pbuf[kWarps][kSub][32] (each pixel's w and dpow of the
// sub-batch's pairs, for the products), gbuf[kWarps][32][4] (rgb + depth:
// each pixel's value cotangents), part[kWarps][kBatch][kWords] (the warps'
// partial sums) and rows[kBatch][kStride] (the staged pairs, unpacked and
// pair-major: all lanes read one row, 16 bytes at a time) floats,
// gid[kBatch] and warp_max[kWarps] ints.
template <int NV, int NPACK, bool WITH_COLOR, bool VALUES_ONLY>
struct Layout {
  static constexpr int kPlain = WITH_COLOR ? 4 : 0;  // rgb + depth
  static constexpr int kPayWords = kGeom + (NPACK > 0 ? kPlain + NPACK : NV);
  static constexpr int kWords = kGeom + NV;  // gradient row, always unpacked
  // 32 features (alone, or at value columns 3-34 beside rgb + depth): d v
  // by lane c over the warp's pixels, feature c
  static constexpr bool kValueProduct = NV >= 32;
  static constexpr int kFeat0 = WITH_COLOR ? 3 : 0;  // first feature column
  // rgb + depth (value columns 0-2 and NV - 1): beside the geometry
  // moments, 4 lanes per pair over 8 pixels each
  static constexpr int kQV = kPlain;
  // the moment lanes run for the geometry (full mode) or rgb + depth
  static constexpr bool kMoments = !VALUES_ONLY || kQV > 0;
  static constexpr int kWbuf = kWarps * kSub * 32;
  static constexpr int kPbuf = VALUES_ONLY ? 0 : kWarps * kSub * 32;
  static constexpr int kGbuf = kQV > 0 ? kWarps * 32 * 4 : 0;
  static constexpr int kPart = kWarps * kBatch * kWords;
  static constexpr int kStride = (kWords + 3) / 4 * 4;  // 16-byte rows
  static constexpr int kRows = kBatch * kStride;
  static constexpr size_t kSmem =
      sizeof(float) * (kWbuf + kPbuf + kGbuf + kPart + kRows) +
      sizeof(int) * (kBatch + kWarps);
  // blocks per SM the registers must allow: the 10-word layouts keep few
  // values per pixel and need more warps in flight to hide their latency;
  // the 42-word full mode holds 37 cotangents and 32 product terms per
  // thread, and its shared memory (118,048 B) fits one block per SM anyway
  static constexpr int kMinBlocks =
      !kValueProduct ? 4 : (WITH_COLOR && !VALUES_ONLY ? 1 : 2);
};

template <int NV, int NPACK, bool WITH_COLOR, bool VALUES_ONLY>
__global__ void __launch_bounds__(
    kPix, (Layout<NV, NPACK, WITH_COLOR, VALUES_ONLY>::kMinBlocks))
composite_bwd_kernel(const float* __restrict__ payload,
                     const int* __restrict__ sorted_gauss,
                     const int* __restrict__ tile_start, int tw, int ty0,
                     int height, int width, const float* __restrict__ grad_out,
                     const float* __restrict__ res_logt,
                     const int* __restrict__ res_stop, float log_alpha_max,
                     float log_alpha_eps, float* __restrict__ dpair,
                     float* __restrict__ logt_first) {
  using L = Layout<NV, NPACK, WITH_COLOR, VALUES_ONLY>;
  static_assert(NPACK == 0 || NV == L::kPlain + 2 * NPACK,
                "packed value layout: rgb + depth and 2 NPACK features, or "
                "the features alone");
  static_assert(NV == L::kQV + (L::kValueProduct ? 32 : 0),
                "value words: rgb + depth, 32 features, or both");
  constexpr int kWords = L::kWords;
  constexpr int kPayWords = L::kPayWords;
  constexpr int kStride = L::kStride;
  extern __shared__ float4 smem4[];
  float* wbuf = reinterpret_cast<float*>(smem4);  // 16-byte aligned
  float* pbuf = wbuf + L::kWbuf;
  float* gbuf = pbuf + L::kPbuf;
  float* part = gbuf + L::kGbuf;
  float* rows = part + L::kPart;
  int* gid = reinterpret_cast<int*>(rows + L::kRows);
  int* warp_max = gid + kBatch;

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
  const float oy = (float)((ty0 + ty) * kTile);  // in the image
  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];

  const int px = tx * kTile + lx;
  const int py = ty * kTile + ly;
  float g[1 + NV];  // this pixel's cotangent [g_acc, g_values]
  if (px < width && py < height) {
    const float* gp = grad_out + ((size_t)py * width + px) * (1 + NV);
#pragma unroll
    for (int c = 0; c < 1 + NV; ++c) g[c] = gp[c];
  } else {
#pragma unroll
    for (int c = 0; c < 1 + NV; ++c) g[c] = 0.f;
  }
  // value product: lane c holds g_c at each of its warp's 32 pixels
  float gt[L::kValueProduct ? 32 : 1];
  if constexpr (L::kValueProduct) {
#pragma unroll
    for (int p = 0; p < 32; ++p) {
      const int qx = tx * kTile + (warp * 32 + p) % kTile;
      const int qy = ty * kTile + (warp * 32 + p) / kTile;
      gt[p] = qx < width && qy < height
                  ? grad_out[((size_t)qy * width + qx) * (1 + NV) + 1 +
                             L::kFeat0 + lane]
                  : 0.f;
    }
  }
  if constexpr (L::kQV > 0)  // read after the first batch's barrier
    reinterpret_cast<float4*>(gbuf)[threadIdx.x] =
        make_float4(g[1], g[2], g[3], g[NV]);
  float logt = res_logt[(size_t)tile * kPix + threadIdx.x];
  const int my_stop = res_stop[(size_t)tile * kPix + threadIdx.x];
  float suffix = 0.f;

  const int warp_stop = __reduce_max_sync(kFull, my_stop);
  if (lane == 0) warp_max[warp] = warp_stop;
  __syncthreads();
  int max_stop = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) max_stop = max(max_stop, warp_max[w]);

  // the stop pairs and every later pair of the range: no gradient
  for (int i = max_stop * kWords + threadIdx.x; i < (end - start) * kWords;
       i += kPix)
    dpair[(size_t)start * kWords + i] = 0.f;

  float* my_part = part + warp * kBatch * kWords;
  float* my_w = wbuf + warp * kSub * 32;
  float* my_p = pbuf + warp * kSub * 32;
  for (int hi = max_stop; hi > 0; hi -= kBatch) {
    const int lo = max(hi - kBatch, 0);
    const int n = hi - lo;
    __syncthreads();  // the previous batch's rows and partials are read
    if ((int)threadIdx.x < n) gid[threadIdx.x] = sorted_gauss[start + lo + threadIdx.x];
    __syncthreads();
    for (int i = threadIdx.x; i < n * kPayWords; i += kPix) {
      const int j = i / kPayWords;
      const int c = i - j * kPayWords;
      stage_word<NV, NPACK, WITH_COLOR>(
          rows + j * kStride, c, payload[(size_t)gid[j] * kPayWords + c]);
    }
    __syncthreads();
    for (int s_hi = n; s_hi > 0; s_hi -= kSub) {
      const int s_lo = max(s_hi - kSub, 0);
      unsigned int counted_any = 0;  // bit j - s_lo: a lane counts pair j
      for (int j = s_hi - 1; j >= s_lo; --j) {
        float w = 0.f;
        float dpow = 0.f;
        bool any = false;
        if (lo + j < warp_stop) {  // warp-uniform: else no lane counts pair j
          const float* rj = rows + j * kStride;
          const float4 ga = *reinterpret_cast<const float4*>(rj + NV);
          const float2 gb = *reinterpret_cast<const float2*>(rj + NV + 4);
          const float dx = (ga.x - ox) - fx;
          const float dy = (ga.y - oy) - fy;
          const float raw = -0.5f * (ga.z * dx * dx + gb.x * dy * dy) -
                            ga.w * dx * dy + gb.y;
          const float alog = fminf(raw, log_alpha_max);
          const bool counted = (lo + j < my_stop) && (alog >= log_alpha_eps);
          any = __any_sync(kFull, counted);
          if (counted) {
            const float alpha = expf(alog);
            const float before = logt - log1pf(-alpha);
            const float t = expf(before);
            w = alpha * t;
            if constexpr (!VALUES_ONLY) {
              float q = g[0];
              const float4* v4 = reinterpret_cast<const float4*>(rj);
#pragma unroll
              for (int c4 = 0; c4 < NV / 4; ++c4) {
                const float4 v = v4[c4];
                q += g[1 + 4 * c4] * v.x;
                q += g[2 + 4 * c4] * v.y;
                q += g[3 + 4 * c4] * v.z;
                q += g[4 + 4 * c4] * v.w;
              }
              const float dalpha = q * t - suffix / (1.f - alpha);
              suffix += q * w;
              dpow = raw < log_alpha_max ? dalpha * alpha : 0.f;
            }
            logt = before;
          }
        }
        my_w[(j - s_lo) * 32 + lane] = w;
        if constexpr (!VALUES_ONLY) my_p[(j - s_lo) * 32 + lane] = dpow;
        counted_any |= (unsigned int)any << (j - s_lo);
      }
      __syncwarp();
      const int m = s_hi - s_lo;
      if constexpr (L::kValueProduct) {
        // d v_c over the warp's pixels, lane c: sum_p w_p g_c,p in pixel
        // order (float32 fused multiply-adds)
        const float4* w4 = reinterpret_cast<const float4*>(my_w);
        for (int jj = 0; jj < m; ++jj) {
          float acc = 0.f;
          if ((counted_any >> jj) & 1u) {
#pragma unroll
            for (int p4 = 0; p4 < 8; ++p4) {
              const float4 v = w4[jj * 8 + p4];
              acc = __fmaf_rn(v.x, gt[4 * p4], acc);
              acc = __fmaf_rn(v.y, gt[4 * p4 + 1], acc);
              acc = __fmaf_rn(v.z, gt[4 * p4 + 2], acc);
              acc = __fmaf_rn(v.w, gt[4 * p4 + 3], acc);
            }
          }
          my_part[(s_lo + jj) * kWords + kGeom + L::kFeat0 + lane] = acc;
        }
      }
      if constexpr (L::kMoments) {
        // the geometry words through the monomial basis: 4 lanes per pair,
        // each over 8 pixels of one pixel row (u, v: the pixel's offsets
        // from the tile's centre), sum dpow, dpow u, dpow u^2; the 4 are
        // summed by two xor steps with v dpow, v dpow u, v^2 dpow formed
        // per row; then, with dx = mx' - u and dy = my' - v (mx', my': the
        // mean's offsets from the centre), every sum of dpow times a
        // quadratic in dx, dy is a combination of the six moments.
        // rgb + depth: the same lanes sum w g_c over the same pixels; in
        // values-only mode these sums alone, the full mode's bit for bit
        const int jj = lane >> 2;
        const int quarter = lane & 3;
        const bool live = jj < m && ((counted_any >> jj) & 1u);
        const float u0 = (float)(8 * (quarter & 1)) - 7.5f;
        const float v = (float)(2 * warp + (quarter >> 1)) - 7.5f;
        constexpr int kQV = L::kQV;
        constexpr int kM0 = VALUES_ONLY ? kGeom : 0;  // first moment summed
        float s0 = 0.f, su = 0.f, suu = 0.f;
        float mom[6 + kQV] = {};
        if (live) {
          const float4* p4 =
              reinterpret_cast<const float4*>(my_p + jj * 32 + 8 * quarter);
          const float4* w4 =
              reinterpret_cast<const float4*>(my_w + jj * 32 + 8 * quarter);
#pragma unroll
          for (int x4 = 0; x4 < 2; ++x4) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            if constexpr (!VALUES_ONLY) {
              const float4 d4 = p4[x4];
              d[0] = d4.x;
              d[1] = d4.y;
              d[2] = d4.z;
              d[3] = d4.w;
            }
            float wk[4] = {0.f, 0.f, 0.f, 0.f};
            if constexpr (kQV > 0) {
              const float4 wq = w4[x4];
              wk[0] = wq.x;
              wk[1] = wq.y;
              wk[2] = wq.z;
              wk[3] = wq.w;
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if constexpr (!VALUES_ONLY) {
                const float u = u0 + (float)(4 * x4 + k);
                s0 += d[k];
                su = __fmaf_rn(d[k], u, su);
                suu = __fmaf_rn(d[k], u * u, suu);
              }
              if constexpr (kQV > 0) {
                const float4 gq = reinterpret_cast<const float4*>(
                    gbuf)[warp * 32 + 8 * quarter + 4 * x4 + k];
                mom[6] = __fmaf_rn(wk[k], gq.x, mom[6]);
                mom[7] = __fmaf_rn(wk[k], gq.y, mom[7]);
                mom[8] = __fmaf_rn(wk[k], gq.z, mom[8]);
                mom[9] = __fmaf_rn(wk[k], gq.w, mom[9]);
              }
            }
          }
        }
        if constexpr (!VALUES_ONLY) {
          mom[0] = s0;
          mom[1] = su;
          mom[2] = suu;
          mom[3] = v * s0;
          mom[4] = v * su;
          mom[5] = v * v * s0;
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
#pragma unroll
          for (int k = kM0; k < 6 + kQV; ++k)
            mom[k] += __shfl_xor_sync(kFull, mom[k], off);
        }
        if (quarter == 0 && jj < m) {
          float* pj = my_part + (s_lo + jj) * kWords;
          if constexpr (!VALUES_ONLY) {
            float d[kGeom] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            if (live) {
              const float* rj = rows + (s_lo + jj) * kStride;
              const float4 ga = *reinterpret_cast<const float4*>(rj + NV);
              const float cc = rj[NV + 4];
              const float mx = (ga.x - ox) - 7.5f;
              const float my = (ga.y - oy) - 7.5f;
              const float s = mom[0], su_ = mom[1], suu_ = mom[2];
              const float sv = mom[3], suv = mom[4], svv = mom[5];
              const float sdx = mx * s - su_;  // sum dpow dx
              const float sdy = my * s - sv;
              const float sdxx = mx * (mx * s - 2.f * su_) + suu_;
              const float sdxy = mx * (my * s - sv) - my * su_ + suv;
              const float sdyy = my * (my * s - 2.f * sv) + svv;
              d[0] = -(ga.z * sdx + ga.w * sdy);
              d[1] = -(cc * sdy + ga.w * sdx);
              d[2] = -0.5f * sdxx;
              d[3] = -sdxy;
              d[4] = -0.5f * sdyy;
              d[5] = s;
            }
#pragma unroll
            for (int c = 0; c < kGeom; ++c) pj[c] = d[c];
          }
#pragma unroll
          for (int c = 0; c < kQV; ++c)  // rgb at columns 0-2, depth last
            pj[kGeom + (c < 3 ? c : NV - 1)] = live ? mom[6 + c] : 0.f;
        }
      }
      __syncwarp();  // w, dpow of this sub-batch read before the next's
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * kWords; i += kPix) {
      const int j = i / kWords;
      const int c = i - j * kWords;
      float s = 0.f;
      if (!VALUES_ONLY || c >= kGeom) {
        s = part[j * kWords + c];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += part[(w * kBatch + j) * kWords + c];
      }
      dpair[(size_t)(start + lo + j) * kWords + c] = s;
    }
  }
  if (logt_first != nullptr)
    logt_first[(size_t)tile * kPix + threadIdx.x] = logt;
}

// One warp per `per_warp` gaussians; words / 2 lanes per gaussian, a float2
// of its row each. `chunk` = min(k, 32) positions per gaussian are loaded
// per round, lane l loading position l % chunk of gaussian l / chunk.
__global__ void __launch_bounds__(256)
reduce_pair_grads_kernel(const float* __restrict__ dpair,
                         const int* __restrict__ inv,
                         const int* __restrict__ lo_at,
                         const int* __restrict__ hi_at, int n, int k,
                         int words, int per_warp,
                         float* __restrict__ dpayload) {
  const int lane = threadIdx.x & 31;
  const int64_t g0 =
      (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * per_warp;
  if (g0 >= n) return;  // warp-uniform
  const int half = words >> 1;
  const int chunk = min(k, 32);
  const int gi = lane / half;  // this lane's gaussian within the warp
  const int c2 = lane - gi * half;  // and its float2 of the row
  const bool active = gi < per_warp && g0 + gi < n;
  const int lg = lane / chunk;  // the gaussian whose position lane loads
  const int lk = lane - lg * chunk;
  const bool loads = lg < per_warp && g0 + lg < n;
  const int lo = *lo_at;
  const unsigned span = (unsigned)(*hi_at - lo);
  const float2* rows = reinterpret_cast<const float2*>(dpair);
  float2 s = make_float2(0.f, 0.f);
  for (int k0 = 0; k0 < k; k0 += chunk) {
    const int len = min(chunk, k - k0);
    int mine = loads && lk < len ? inv[(g0 + lg) * k + k0 + lk] : 0;
    if ((unsigned)(mine - lo) >= span) mine = -1;  // outside the range
    for (int r0 = 0; r0 < len; r0 += 8) {
      float2 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {  // the loads first, all in flight
        const int pos = __shfl_sync(kFull, mine, (gi * chunk + r0 + u) & 31);
        v[u] = make_float2(0.f, 0.f);
        if (active && r0 + u < len && pos >= 0)
          v[u] = rows[(size_t)pos * half + c2];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {  // then the sums, in k order
        if (r0 + u < len) {
          s.x += v[u].x;
          s.y += v[u].y;
        }
      }
    }
  }
  if (active)
    reinterpret_cast<float2*>(dpayload)[(g0 + gi) * half + c2] = s;
}

// Slab mode's reduce: the slab's pairs alone, where reduce_pair_grads_kernel
// reads every gaussian's K positions for every slab. dpayload is zeroed
// first. Each warp takes 32 consecutive sorted positions p in [lo, hi) per
// round (grid-stride); lane l's pair, of gaussian g = sorted_gauss[p], leads
// g's sum when none of g's positions before p's own (inv[g K + j] == p)
// lies in the range. The warp's leaders are summed as
// reduce_pair_grads_kernel sums a gaussian, words / 2 lanes each, a float2
// of the row per lane (coalesced rows), per_warp groups of lanes at a time
// and kLeads leaders per group with their loads in flight together: every
// slot in k order, reading 0 outside the range. These are the additions of
// reduce_pair_grads_kernel, so the two agree bit for bit. Measured on the
// bench scene's 4 slabs at 38 words (PERF.md, PR 11): 0.024-0.037 ms a
// slab; one leader per group at a time took 0.037-0.049 (about ten
// latency chains one after another), one thread per leader with its row
// in registers 0.022-0.053 (each load instruction touching 32 rows), and
// reduce_pair_grads_kernel over the slab's range 0.050-0.052, with four
// gaussians a group in flight 0.039-0.048.
constexpr int kLeads = 4;

__global__ void __launch_bounds__(256)
reduce_slab_pairs_kernel(const float* __restrict__ dpair,
                         const int* __restrict__ sorted_gauss,
                         const int* __restrict__ inv,
                         const int* __restrict__ lo_at,
                         const int* __restrict__ hi_at, int k, int words,
                         int per_warp, float* __restrict__ dpayload) {
  __shared__ int lead_g[8][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int lo = *lo_at;
  const int hi = *hi_at;
  const unsigned span = (unsigned)(hi - lo);
  const int half = words >> 1;
  const int gi = lane / half;  // this lane's group
  const int c2 = lane - gi * half;  // and its float2 of the row
  const float2* rows = reinterpret_cast<const float2*>(dpair);
  float2* out = reinterpret_cast<float2*>(dpayload);
  const int64_t stride = (int64_t)gridDim.x * (blockDim.x >> 5) * 32;
  for (int64_t base = lo + ((int64_t)blockIdx.x * (blockDim.x >> 5) + w) * 32;
       base < hi; base += stride) {
    const int64_t p = base + lane;
    int g = 0;
    bool lead = false;
    if (p < hi) {
      g = sorted_gauss[p];
      const int* slots = inv + (int64_t)g * k;
      lead = true;
      for (int j = 0; j < k; ++j) {
        const int q = slots[j];
        if (q == p) break;
        if ((unsigned)(q - lo) < span) {
          lead = false;
          break;
        }
      }
    }
    const unsigned leaders = __ballot_sync(kFull, lead);
    if (lead) lead_g[w][__popc(leaders & ((1u << lane) - 1u))] = g;
    __syncwarp();
    const int nl = __popc(leaders);
    for (int r0 = 0; r0 < nl; r0 += per_warp * kLeads) {
      int gg[kLeads];
      float2 s[kLeads];
#pragma unroll
      for (int l = 0; l < kLeads; ++l) {
        const int r = r0 + l * per_warp + gi;
        gg[l] = gi < per_warp && r < nl ? lead_g[w][r] : -1;
        s[l] = make_float2(0.f, 0.f);
      }
      for (int jb = 0; jb < k; jb += 8) {
        int q[kLeads][8];
#pragma unroll
        for (int l = 0; l < kLeads; ++l)  // the positions, then the rows
#pragma unroll
          for (int u = 0; u < 8; ++u)
            q[l][u] = gg[l] >= 0 && jb + u < k
                          ? inv[(int64_t)gg[l] * k + jb + u] : lo - 1;
        float2 v[kLeads][8];
#pragma unroll
        for (int l = 0; l < kLeads; ++l)
#pragma unroll
          for (int u = 0; u < 8; ++u)
            v[l][u] = (unsigned)(q[l][u] - lo) < span
                          ? rows[(size_t)q[l][u] * half + c2]
                          : make_float2(0.f, 0.f);
#pragma unroll
        for (int l = 0; l < kLeads; ++l)  // the sums, in k order
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (jb + u < k) {
              s[l].x += v[l][u].x;
              s[l].y += v[l][u].y;
            }
      }
#pragma unroll
      for (int l = 0; l < kLeads; ++l)
        if (gg[l] >= 0) out[(size_t)gg[l] * half + c2] = s[l];
    }
    __syncwarp();  // the leaders read before the next round's
  }
}

template <int NV, int NPACK, bool COLOR, bool VONLY>
int launch_bwd(int num_tiles, cudaStream_t s, const float* payload,
               const int* sorted_gauss, const int* tile_start, int tw,
               int ty0, int height, int width, const float* grad_out,
               const float* res_logt, const int* res_stop,
               float log_alpha_max, float log_alpha_eps, float* dpair,
               float* logt_first) {
  auto kernel = composite_bwd_kernel<NV, NPACK, COLOR, VONLY>;
  const int bytes = (int)Layout<NV, NPACK, COLOR, VONLY>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_tiles, kPix, bytes, s>>>(
      payload, sorted_gauss, tile_start, tw, ty0, height, width, grad_out,
      res_logt, res_stop, log_alpha_max, log_alpha_eps, dpair, logt_first);
  return (int)cudaGetLastError();
}

}  // namespace

// C interfaces for ctypes. Each returns the launch's cudaError_t
// (0 = success), or cudaErrorInvalidValue for a value layout without an
// instantiation. The backward walks num_tiles tiles of a tw-wide grid whose
// first tile row is image row ty0 * 16 (a slab, as the forward's; the
// whole image is ty0 = 0), tile_start pointing at the first one's entry,
// grad_out (height, width, 1 + n_val) and the residuals the slab's; it
// writes the rows of dpair at the slab's sorted pair positions only.
// logt_first (num_tiles * 256) is optional: when not null it
// receives each pixel's log T reconstructed back to the tile's first pair,
// which is 0 up to rounding (a check of the reverse walk).
extern "C" int trase_composite_bwd(const float* payload,
                                   const int* sorted_gauss,
                                   const int* tile_start, int num_tiles,
                                   int tw, int ty0, int height, int width,
                                   int n_val,
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
      (values_only != 0) == VONLY)                                         \
    return launch_bwd<NV, NPACK, COLOR, VONLY>(                            \
        num_tiles, s, payload, sorted_gauss, tile_start, tw, ty0, height,  \
        width, grad_out, res_logt, res_stop, log_alpha_max, log_alpha_eps, \
        dpair, logt_first);
  TRASE_BWD(4, 0, true, false)
  TRASE_BWD(4, 0, true, true)
  TRASE_BWD(36, 0, true, false)
  TRASE_BWD(36, 0, true, true)
  TRASE_BWD(36, 16, true, false)
  TRASE_BWD(36, 16, true, true)
  TRASE_BWD(32, 0, false, false)
  TRASE_BWD(32, 0, false, true)
  TRASE_BWD(32, 16, false, false)
  TRASE_BWD(32, 16, false, true)
#undef TRASE_BWD
  return (int)cudaErrorInvalidValue;
}

// lo_at / hi_at point at the sorted pair range's ends on the device (no
// host sync): tile_start[t_lo] and tile_start[t_hi] of a slab, or
// tile_start[0] = 0 and tile_start[num_tiles] for the whole image. Rows of
// an even number of words, at most 64 (float2 lanes per gaussian).
extern "C" int trase_reduce_pair_grads(const float* dpair, const int* inv,
                                       const int* lo_at, const int* hi_at,
                                       int n, int k,
                                       int words, float* dpayload,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || k <= 0 || words <= 0 || words % 2 || words > 64)
    return (int)cudaErrorInvalidValue;
  const int half = words / 2;
  const int chunk = k < 32 ? k : 32;
  const int per_warp = 32 / half < 32 / chunk ? 32 / half : 32 / chunk;
  const int64_t warps = ((int64_t)n + per_warp - 1) / per_warp;
  const int threads = 256;
  const int blocks = (int)((warps * 32 + threads - 1) / threads);
  reduce_pair_grads_kernel<<<blocks, threads, 0, s>>>(
      dpair, inv, lo_at, hi_at, n, k, words, per_warp, dpayload);
  return (int)cudaGetLastError();
}

// Slab mode's reduce (reduce_slab_pairs_kernel): the slab's pair range
// [*lo_at, *hi_at) alone, the (n, words) output zeroed first. Rows of an
// even number of words, at most 64 (float2 lanes per gaussian). The grid
// covers up to 16 blocks of 8 warps per SM and strides over the range,
// whose size only the device knows.
extern "C" int trase_reduce_slab_pairs(const float* dpair,
                                       const int* sorted_gauss,
                                       const int* inv, const int* lo_at,
                                       const int* hi_at, int n, int k,
                                       int words, float* dpayload,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || k <= 0 || words <= 0 || words % 2 || words > 64)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      dpayload, 0, (size_t)n * words * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 256;
  const int64_t need = ((int64_t)n * k + threads - 1) / threads;
  const int blocks = (int)(need < 16LL * sms ? need : 16LL * sms);
  reduce_slab_pairs_kernel<<<blocks, threads, 0, s>>>(
      dpair, sorted_gauss, inv, lo_at, hi_at, k, words, 32 / (words / 2),
      dpayload);
  return (int)cudaGetLastError();
}
