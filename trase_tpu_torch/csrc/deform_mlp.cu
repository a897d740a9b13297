// Fused deformation MLP, inference: the CUDA port of trase_tpu's Pallas
// kernel `_kernel` (trase_tpu/ops/mlp_pallas.py:41, launched by
// `fused_deform_mlp`, :76), the fast path of deform_step(fused=True) for
// the standard DeformNetwork (8 x 256 ReLU stack, skip after layer 4, no
// 6-DoF head, no feature input, no blender time-net).
//
// What it computes, per gaussian row (emb = [x_emb | t_emb], in_dim f32):
//   inp = bf16(emb)                                   round to nearest even
//   h   = bf16(relu(f32acc(inp @ W0) + b0))
//   h   = bf16(relu(f32acc(h @ Wl) + bl))             l = 1..4
//   h   = bf16(relu(f32acc(inp @ Ws_in + h @ Ws_h) + b5))   the skip,
//         concat(inp, h) @ W5 split into its input and hidden rows
//   h   = bf16(relu(f32acc(h @ Wl) + bl))             l = 6, 7
//   out = f32(h) @ Wh + bh                            the three heads, f32
// and writes d_xyz (N, 3), d_rot (N, 4), d_scale (N, 3) float32. The
// biases are float32 and are added to the float32 accumulator before the
// bf16 rounding (not flax's Dense(dtype=bf16), which rounds the bias).
// ReLU is `v < 0 ? 0 : v`, so a NaN passes through as in jnp.maximum and
// torch.relu. The plain PyTorch version (ops/mlp_cuda.py:
// deform_mlp_plain) computes the same chain with float32 products of the
// bf16-rounded operands; the two differ only in the order of the float32
// sums, which can round an activation near a bf16 boundary the other way.
// Rows past N are never written; no float atomics, so a relaunch gives
// the same bits.
//
// Bound on one H100 SXM at the serving path's N = 131072 (the bench
// scene's capacity, in_dim 84): 504,320 multiply-adds per row
// (84*256 + 4*256^2 + 340*256 + 2*256^2 + 256*10), 1.32e11 FLOP, 0.133 ms
// at the 989 TFLOP/s dense bf16 tensor-core peak; 44 MB of emb read and
// 5 MB written, 0.015 ms at 3.35 TB/s. So the kernel is bound by
// operations, and all its intermediates stay on chip: the TPU kernel's
// reason to exist (eight (N, 256) activations never touch HBM) carries
// over unchanged.
//
// What stands between the kernel and that bound is feeding the tensor
// cores: the weights, and each layer's activations. The bf16 weights
// (1 MB with the input K padded to 128) are four times what one block's
// shared memory holds, so they stream through it layer by layer for
// every row tile, from the L2: 1 GB of L2 reads at N = 131072 with 128
// rows a tile (the stream alone takes 0.11 ms through a 5-stage ring on
// one H100 80GB HBM3 at 700 W, below the products' time, so no cluster
// multicast). The design:
//   - one persistent block per SM (grid = min(tiles, SMs)) walks tiles of
//     128 rows; 384 threads: two consumer warpgroups of 64 rows each, so
//     both share every weight fetch, and a producer warpgroup whose
//     registers (setmaxnreg 24) go to the consumers (240);
//   - one producer lane streams the 32 weight chunks of a tile (64 K x
//     256 N bf16, 32 KB each, laid out by the wrapper in the exact
//     128-byte swizzled order a stage lands in: ops/mlp_cuda.py:
//     device_layout) into a 5-stage ring, one cp.async.bulk per chunk,
//     each completing on its stage's `full` mbarrier; each consumer
//     warpgroup frees a stage on its `empty` mbarrier once its products
//     on it are done. It also prefetches the next tile's emb into the L2;
//   - products are wgmma.mma_async m64n256k16 bf16 -> f32 with B (the
//     stage) from shared memory, K-major with the 128-byte swizzle:
//     nn.Linear's (out, in) weight is the K-major B operand as it is;
//   - the two consumers take turns to issue a layer's products (two
//     named barriers, FlashAttention-3's ping-pong), so one's epilogue,
//     heads and input load run beside the other's products; a turn takes
//     at most 4 chunks (the skip's 6 are two turns), or it would wait for
//     a stage the other consumer frees only in its own turn;
//   - activations never leave registers: a layer's epilogue adds the
//     bias (from shared memory), applies ReLU and rounds pairs to bf16
//     straight from the float32 accumulator (m64nN layout: 2 rows x 64
//     columns a thread) into the A fragment of the next layer's products
//     (64 registers: the accumulator's layout is the A fragment's, 8
//     columns of one k16 step apart), as FlashAttention-3 feeds P;
//   - the 64 x 128 bf16 input (16 KB a warpgroup, swizzled) stays in
//     shared memory for layer 0 and the skip, which read A from there;
//     the next tile's is loaded once the skip has read it, while the
//     consumer waits for its turn at layer 7;
//   - the 256 -> 10 float32 heads run on the CUDA cores from layer 7's
//     accumulator: each thread holds 2 rows x 64 columns, forms 10
//     partial dot products per row against Wh in shared memory, two
//     shuffles within each quad complete them, then bh;
//   - the input K (in_dim 68, 84 or 128) is padded to 128 with zeros,
//     exact in every product; rows past N are zero and never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 256;                  // hidden width: wgmma N
constexpr int kOut = 10;                     // d_xyz 3 + d_rot 4 + d_scale 3
constexpr int kLayers = 8;
constexpr int kWgRows = 64;                  // rows per consumer: wgmma M
constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kTileRows = kConsumers * kWgRows;
constexpr int kProducerWarp = kConsumers * 4;
constexpr int kThreads = kConsumers * 128 + 128;  // + the producer's
// registers a thread: the producer warpgroup gives back what the
// consumers take (384 threads x 168 = 2 x 128 x 240 + 128 x 24)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kStages = 5;
constexpr int kChunkK = 64;                  // one 128-byte swizzle row
constexpr int kChunkBytes = kWidth * kChunkK * 2;
constexpr int kKin = 128;                    // the input's K, zero-padded
constexpr int kInChunks = kKin / kChunkK;
constexpr int kHidChunks = kWidth / kChunkK;
// chunks of one tile, in the order they are consumed: W0, W1..W4,
// Ws_in, Ws_h, W6, W7
constexpr int kChunks = kInChunks + 4 * kHidChunks + kInChunks +
                        kHidChunks + 2 * kHidChunks;
constexpr int kAtomBytes = kWgRows * 128;    // 64 rows x 64 bf16
// a consumer's turn (gemm) takes at most kStages - 1 chunks
static_assert(kHidChunks < kStages && kInChunks < kStages, "ring too short");

// shared memory, from a 1024-byte aligned base (the swizzle's period):
// the ring, each warpgroup's input, biases, heads, mbarriers
constexpr int kRingOff = 0;
constexpr int kInpOff = kRingOff + kStages * kChunkBytes;
constexpr int kBiasOff = kInpOff + kConsumers * kInChunks * kAtomBytes;
constexpr int kWhOff = kBiasOff + kLayers * kWidth * 4;
constexpr int kBhOff = kWhOff + kWidth * kOut * 4;
constexpr int kBarOff = kBhOff + 64;
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait of more than
// ~10 s (2^34 clocks) means a broken pipeline: it traps, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// an arrival by the threads whose `pred` is set, predicated inside the
// instruction so the warp does not diverge around it
__device__ __forceinline__ void mbar_arrive(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// one contiguous global -> shared copy, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// generic-proxy shared-memory writes made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers, in their non-aligned form (barrier.sync, not bar.sync):
// each thread counts itself, so a warp need not be converged.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("barrier.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// the two consumers' turns to issue products: named barriers 3 and 4,
// each completed by one warpgroup's sync and the other's arrival
constexpr int kTurnBar = 3;

__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("barrier.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("barrier.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// wgmma matrix descriptor: K-major, 128-byte swizzle, 8-row groups 1024
// bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wait
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),     \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A (64 x 16) @ B (16 x 256): A and B from shared memory
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56), ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96),
        ACC8(104), ACC8(112), ACC8(120)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A (64 x 16, registers: mma's A fragment, 4 bf16 pairs a
// thread) @ B (16 x 256, shared memory)
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                    const uint32_t* a,
                                                    uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56), ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96),
        ACC8(104), ACC8(112), ACC8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef ACC8

// keeps the A fragment's registers reserved until its products are done
__device__ __forceinline__ void fence_frag(uint32_t (&h)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(h[i])::"memory");
}

// a consumer's view of the weight ring and of the turns
struct Ring {
  uint32_t base;   // stage 0
  uint32_t full;   // kStages mbarriers, 8 bytes apart
  uint32_t empty;
  int stage;
  uint32_t phase;
  bool signal;     // the warpgroup's thread that frees stages
  int mine, theirs;  // the turn barriers this consumer waits on / passes
};

// One turn: acc (+)= A @ W^T over the ring's next NCHUNKS chunks. A is
// the fragment h (64 x 256 bf16, FROM_REGS) or 64 rows x (64 NCHUNKS)
// bf16 in NCHUNKS swizzle atoms of shared memory from `a`. The warpgroup
// waits for its turn, issues, hands the turn on and then waits for its
// products, so the two consumers issue in turn and one's epilogue, heads
// or input load overlaps the other's products. Each chunk's stage is
// freed (one arrival per warpgroup) once the products on it have
// completed: the previous chunk's after the next is issued. A turn takes
// at most kStages - 1 chunks: the other consumer frees the previous
// turn's last chunk only after its own turn.
template <int NCHUNKS, bool FROM_REGS>
__device__ __forceinline__ void gemm(float (&acc)[128], uint32_t a,
                                     uint32_t (&h)[64], bool accumulate,
                                     Ring& r) {
  turn_wait(r.mine);
  int prev = 0;
#pragma unroll
  for (int c = 0; c < NCHUNKS; ++c) {
    mbar_wait(r.full + 8 * r.stage, r.phase);
    const uint32_t b = r.base + r.stage * kChunkBytes;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kChunkK / 16; ++s) {
      const int acc_in = (accumulate || c > 0 || s > 0) ? 1 : 0;
      if (FROM_REGS)
        wgmma_m64n256k16_rs(acc, h + 4 * (4 * c + s), sw128_desc(b + 32 * s),
                            acc_in);
      else
        wgmma_m64n256k16(acc, sw128_desc(a + c * kAtomBytes + 32 * s),
                         sw128_desc(b + 32 * s), acc_in);
    }
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      mbar_arrive(r.empty + 8 * prev, r.signal);
    }
    prev = r.stage;
    if (++r.stage == kStages) {
      r.stage = 0;
      r.phase ^= 1;
    }
  }
  turn_pass(r.theirs);
  wgmma_wait<0>();
  fence_acc(acc);
  fence_frag(h);
  mbar_arrive(r.empty + 8 * prev, r.signal);
}

__device__ __forceinline__ float relu(float v) {
  return v < 0.0f ? 0.0f : v;  // NaN passes through
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The next layer's A fragment from this layer's accumulator: h = bf16(
// relu(acc + b)) in pairs. Thread (warp w, lane) holds accumulator rows
// 16 w + lane / 4 (+ 8 in acc[4 j + 2, 3]) at columns 8 j + 2 (lane % 4)
// + {0, 1}; k16 step s of the A fragment is {row, k 2 q | row + 8, k 2 q
// | row, k 2 q + 8 | row + 8, k 2 q + 8} of columns 16 s.., that is
// h[4 s + i] = acc[8 s + 2 i], acc[8 s + 2 i + 1].
__device__ __forceinline__ void to_frag(const float (&acc)[128],
                                        const float* bias, uint32_t (&h)[64],
                                        int lane) {
  const int q = lane & 3;
#pragma unroll
  for (int s = 0; s < kWidth / 16; ++s) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 b =
          *reinterpret_cast<const float2*>(bias + 16 * s + 8 * half + 2 * q);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 2 * half + r;
        h[4 * s + i] = bf16x2(relu(acc[8 * s + 2 * i] + b.x),
                              relu(acc[8 * s + 2 * i + 1] + b.y));
      }
    }
  }
}

// The warpgroup's 64 rows of emb from `row0`, rounded to bf16, into the
// swizzled A layout at `inp`: 128 columns, zero past in_dim and past n.
// Four columns an item, 16 items a thread; `vec` when every row starts
// on 16 bytes.
__device__ __forceinline__ void load_inp(const float* __restrict__ emb,
                                         int n, int in_dim, bool vec,
                                         int row0, uint32_t inp, int t) {
  float4 v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int item = t + 128 * i;
    const int r = item >> 5, c = (item & 31) * 4;
    const int row = row0 + r;
    v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < n && c < in_dim) {
      const float* p = emb + (size_t)row * in_dim + c;
      if (vec) {
        v[i] = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        v[i].x = __ldg(p);
        if (c + 1 < in_dim) v[i].y = __ldg(p + 1);
        if (c + 2 < in_dim) v[i].z = __ldg(p + 2);
        if (c + 3 < in_dim) v[i].w = __ldg(p + 3);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int item = t + 128 * i;
    const int r = item >> 5, c = (item & 31) * 4;
    const uint32_t at = inp + (c >> 6) * kAtomBytes + r * 128 +
                        ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
    asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(at),
                 "r"(bf16x2(v[i].x, v[i].y)), "r"(bf16x2(v[i].z, v[i].w))
                 : "memory");
  }
}

// The heads from layer 7's accumulator: h = bf16(relu(acc + b7)), then
// out = h @ Wh + bh in float32; each quad of lanes shares two rows.
__device__ __forceinline__ void heads(const float (&acc)[128],
                                      const float* bias, const float* wh,
                                      const float* bh, int row_a, int n,
                                      int lane, float* __restrict__ d_xyz,
                                      float* __restrict__ d_rot,
                                      float* __restrict__ d_scale) {
  const int q = lane & 3;
  float pa[kOut], pb[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) pa[o] = pb[o] = 0.0f;
#pragma unroll
  for (int j = 0; j < kWidth / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float be = e ? b.y : b.x;
      const float ha = bf16_round(relu(acc[4 * j + e] + be));
      const float hb = bf16_round(relu(acc[4 * j + 2 + e] + be));
      const float2* wr = reinterpret_cast<const float2*>(wh + (col + e) * kOut);
#pragma unroll
      for (int o = 0; o < kOut / 2; ++o) {
        const float2 w2 = wr[o];
        pa[2 * o] = __fmaf_rn(ha, w2.x, pa[2 * o]);
        pa[2 * o + 1] = __fmaf_rn(ha, w2.y, pa[2 * o + 1]);
        pb[2 * o] = __fmaf_rn(hb, w2.x, pb[2 * o]);
        pb[2 * o + 1] = __fmaf_rn(hb, w2.y, pb[2 * o + 1]);
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    pa[o] += __shfl_xor_sync(0xffffffffu, pa[o], 1);
    pa[o] += __shfl_xor_sync(0xffffffffu, pa[o], 2);
    pb[o] += __shfl_xor_sync(0xffffffffu, pb[o], 1);
    pb[o] += __shfl_xor_sync(0xffffffffu, pb[o], 2);
  }
  const int row_b = row_a + 8;
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    if ((o & 3) != q) continue;
    float* dst = o < 3 ? d_xyz : (o < 7 ? d_rot : d_scale);
    const int w = o < 3 ? 3 : (o < 7 ? 4 : 3);
    const int k = o < 3 ? o : (o < 7 ? o - 3 : o - 7);
    if (row_a < n) dst[(size_t)row_a * w + k] = pa[o] + bh[o];
    if (row_b < n) dst[(size_t)row_b * w + k] = pb[o] + bh[o];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
deform_mlp_kernel(const float* __restrict__ emb, int n, int in_dim,
                  bool vec, const uint8_t* __restrict__ chunks,
                  const float* __restrict__ bias,
                  const float* __restrict__ wh,
                  const float* __restrict__ bh, float* __restrict__ d_xyz,
                  float* __restrict__ d_rot, float* __restrict__ d_scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* bias_s = reinterpret_cast<float*>(smem + kBiasOff);
  float* wh_s = reinterpret_cast<float*>(smem + kWhOff);
  float* bh_s = reinterpret_cast<float*>(smem + kBhOff);
  const uint32_t full = base + kBarOff, empty = full + 8 * kStages;

  const int tid = threadIdx.x;
  for (int i = tid; i < kLayers * kWidth; i += kThreads) bias_s[i] = bias[i];
  for (int i = tid; i < kWidth * kOut; i += kThreads) wh_s[i] = wh[i];
  if (tid < kOut) bh_s[tid] = bh[tid];
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int warp = tid >> 5, lane = tid & 31;
  if (warp >= kProducerWarp) {
    // the producer warpgroup: one lane streams every tile's chunks
    // through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kProducerWarp && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        // the next tile's input into the L2, for the consumers' loads
        const int next = tile + gridDim.x;
        if (vec && next < tiles) {
          const int rows = min(kTileRows, n - next * kTileRows);
          asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                           emb + (size_t)next * kTileRows * in_dim),
                       "r"(rows * in_dim * 4)
                       : "memory");
        }
        for (int c = 0; c < kChunks; ++c) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, kChunkBytes);
          bulk_load(base + kRingOff + stage * kChunkBytes,
                    chunks + (size_t)c * kChunkBytes, kChunkBytes,
                    full + 8 * stage);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 rows of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2, w = warp & 3, t = tid & 127;
  const uint32_t inp = base + kInpOff + wg * kInChunks * kAtomBytes;
  Ring ring{base + kRingOff, full, empty, 0, 0, t == 0, kTurnBar + wg,
            kTurnBar + (wg ^ 1)};
  if (wg == 1) turn_pass(ring.theirs);  // consumer 0 issues first
  float acc[128];
  uint32_t h[64];
  load_inp(emb, n, in_dim, vec, blockIdx.x * kTileRows + wg * kWgRows, inp,
           t);
  fence_async_smem();
  warpgroup_sync(wg);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kTileRows + wg * kWgRows;
    const int next = tile + gridDim.x;
    // the first product overwrites the accumulator (scale-d 0); the
    // zeros only end its live range here
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    // layer 0
    gemm<kInChunks, false>(acc, inp, h, false, ring);
    to_frag(acc, bias_s, h, lane);
    // layers 1..4
    for (int l = 1; l <= 4; ++l) {
      gemm<kHidChunks, true>(acc, 0, h, false, ring);
      to_frag(acc, bias_s + l * kWidth, h, lane);
    }
    // layer 5, the skip: inp @ Ws_in + h @ Ws_h in one accumulation, in
    // two turns (a turn of 6 chunks would wait for a sixth stage)
    gemm<kInChunks, false>(acc, inp, h, false, ring);
    gemm<kHidChunks, true>(acc, 0, h, true, ring);
    to_frag(acc, bias_s + 5 * kWidth, h, lane);
    // layer 6
    gemm<kHidChunks, true>(acc, 0, h, false, ring);
    to_frag(acc, bias_s + 6 * kWidth, h, lane);
    // the next tile's input: the skip was the last to read this one's
    if (next < tiles) {
      load_inp(emb, n, in_dim, vec, next * kTileRows + wg * kWgRows, inp, t);
      fence_async_smem();
      warpgroup_sync(wg);
    }
    // layer 7, then the heads from its accumulator
    gemm<kHidChunks, true>(acc, 0, h, false, ring);
    heads(acc, bias_s + 7 * kWidth, wh_s, bh_s, row0 + 16 * w + (lane >> 2),
          n, lane, d_xyz, d_rot, d_scale);
  }
  if (wg == 0) turn_wait(ring.mine);  // consumer 1's last hand-over
}

}  // namespace

// C interface for ctypes. emb (n, in_dim) float32, in_dim <= 128;
// chunks: the 32 weight chunks of ops/mlp_cuda.py: device_layout, each
// 256 x 64 bf16 (32 KB) in the 128-byte swizzled order, W0 (2), W1..W4
// (4 each), Ws_in (2), Ws_h, W6, W7 (4 each), input columns zero past
// in_dim; bias (8, 256) float32; wh (256, 10) and bh (10,) float32, the
// heads [d_xyz | d_rot | d_scale]. Launches on `stream` and returns the
// launch's cudaError_t (0 = success), cudaErrorInvalidValue for shapes
// the kernel does not take.
extern "C" int trase_deform_mlp(const float* emb, int n, int in_dim,
                                const void* chunks, const float* bias,
                                const float* wh, const float* bh,
                                float* d_xyz, float* d_rot, float* d_scale,
                                void* stream) {
  if (n <= 0 || in_dim <= 0 || in_dim > kKin ||
      ((uintptr_t)chunks & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(deform_mlp_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int blocks = tiles < sms ? tiles : sms;
  const bool vec = in_dim % 4 == 0 && ((uintptr_t)emb & 15) == 0;
  deform_mlp_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      emb, n, in_dim, vec, static_cast<const uint8_t*>(chunks), bias, wh, bh,
      d_xyz, d_rot, d_scale);
  return (int)cudaGetLastError();
}
