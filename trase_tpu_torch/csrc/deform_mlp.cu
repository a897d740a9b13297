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
// The plain PyTorch version (ops/mlp_cuda.py: fused_deform_mlp_plain)
// computes the same chain with float32 products of the bf16-rounded
// operands; the two differ only in the order of the float32 sums, which
// can round an activation near a bf16 boundary the other way.
//
// Bound on one H100 SXM at the serving path's N = 131072 (the bench
// scene's capacity, in_dim 84): 504,320 multiply-adds per row
// (84*256 + 4*256^2 + 340*256 + 2*256^2 + 256*10), 1.32e11 FLOP, 0.134 ms
// at the 989 TFLOP/s dense bf16 tensor-core peak; 44 MB of emb read and
// 5 MB written, 0.015 ms at 3.35 TB/s. So the kernel is bound by
// operations, and all its intermediates stay on chip: the TPU kernel's
// reason to exist (eight (N, 256) activations never touch HBM) carries
// over unchanged.
//
// This first design is simple and correct, not fast:
//   - one 256-thread block (8 warps) per tile of 64 rows; the tile's
//     activations live in dynamic shared memory as bf16 (the input
//     embedding zero-padded to a multiple of 16 columns, and two 64 x 256
//     buffers the layers ping-pong between: 80 KB with the epilogue
//     scratch at in_dim 84, above the 48 KB static limit);
//   - products on the tensor cores through nvcuda::wmma bf16 16x16x16
//     fragments with float32 accumulation (mma.sync underneath); warp w
//     owns output columns [32 w, 32 w + 32) for all 64 rows: 4 x 2
//     accumulator fragments;
//   - weights are read straight from global memory into B fragments
//     (1.0 MB of bf16 hidden weights, resident in the 50 MB L2), each
//     block reading all of them once;
//   - the epilogue stores each accumulator fragment to a per-warp float32
//     scratch tile, adds the bias, applies ReLU (NaN passes through, as
//     jnp.maximum and torch.relu let it) and rounds to bf16 into the next
//     buffer;
//   - the 256 -> 10 float32 head runs on the CUDA cores: each warp takes
//     8 rows, lanes split the 256 inputs, a butterfly of shuffles sums;
//   - rows past N are zero in shared memory and never written out.
// Left for later work: wgmma with TMA-fed shared-memory weight tiles, a
// persistent grid that reads the weights once per SM, and register-
// resident epilogues (no scratch round trip).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;      // rows per block
constexpr int kWidth = 256;    // hidden width
constexpr int kWarps = 8;      // threads per block: 256
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;        // bf16 padding per shared-memory row
constexpr int kActLd = kWidth + kPad;
constexpr int kOut = 10;       // d_xyz 3 + d_rot 4 + d_scale 3

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// acc[m][j] += act[16 m.., :k] @ W^T[:k, n0 + 16 j..]: act row-major with
// leading dimension ld (shared memory), W (256, k) row-major in global
// memory, i.e. W^T column-major with leading dimension k.
__device__ __forceinline__ void accumulate(FragC (&acc)[4][2],
                                           const bf16* act, int ld,
                                           const bf16* __restrict__ w,
                                           int k, int n0) {
  FragA a;
  FragB b[2];
  for (int k0 = 0; k0 < k; k0 += 16) {
    wmma::load_matrix_sync(b[0], w + (size_t)n0 * k + k0, k);
    wmma::load_matrix_sync(b[1], w + (size_t)(n0 + 16) * k + k0, k);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      wmma::load_matrix_sync(a, act + 16 * m * ld + k0, ld);
      wmma::mma_sync(acc[m][0], a, b[0], acc[m][0]);
      wmma::mma_sync(acc[m][1], a, b[1], acc[m][1]);
    }
  }
}

// out[16 m + r][n0 + 16 j + c] = bf16(relu(acc + bias)), through the
// warp's 16 x 16 float32 scratch tile.
__device__ __forceinline__ void epilogue(FragC (&acc)[4][2],
                                         const float* __restrict__ bias,
                                         bf16* out, int n0, float* scratch,
                                         int lane) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[m][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = lane + 32 * i;
        const int r = e >> 4, c = e & 15;
        const int col = n0 + 16 * j + c;
        float v = scratch[e] + bias[col];
        v = v < 0.0f ? 0.0f : v;  // ReLU; NaN passes through
        out[(16 * m + r) * kActLd + col] = __float2bfloat16_rn(v);
      }
      __syncwarp();
    }
  }
}

__device__ __forceinline__ void zero(FragC (&acc)[4][2]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    wmma::fill_fragment(acc[m][0], 0.0f);
    wmma::fill_fragment(acc[m][1], 0.0f);
  }
}

// Dynamic shared memory: inp (64 x (kin + 8) bf16) | act0, act1 (64 x 264
// bf16 each) | scratch (8 warps x 256 float32). Every offset is a multiple
// of 32 bytes, as wmma's load / store pointers need.
__global__ void __launch_bounds__(kThreads)
deform_mlp_kernel(const float* __restrict__ emb, int n, int in_dim, int kin,
                  const bf16* __restrict__ w0,
                  const bf16* __restrict__ ws_in,
                  const bf16* __restrict__ w_hidden,
                  const float* __restrict__ bias,
                  const float* __restrict__ wh,
                  const float* __restrict__ bh, float* __restrict__ d_xyz,
                  float* __restrict__ d_rot, float* __restrict__ d_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int in_ld = kin + kPad;
  bf16* inp = reinterpret_cast<bf16*>(smem);
  bf16* act0 = inp + kRows * in_ld;
  bf16* act1 = act0 + kRows * kActLd;
  float* scratch_all = reinterpret_cast<float*>(act1 + kRows * kActLd);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  float* scratch = scratch_all + warp * 256;
  const int row0 = blockIdx.x * kRows;
  const int n0 = warp * 32;

  // the tile's embedding, rounded to bf16; padding columns and rows past
  // N are zero (exact in every product)
  for (int idx = tid; idx < kRows * kin; idx += kThreads) {
    const int r = idx / kin, c = idx - (idx / kin) * kin;
    const int row = row0 + r;
    float v = 0.0f;
    if (c < in_dim && row < n) v = emb[(size_t)row * in_dim + c];
    inp[r * in_ld + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  FragC acc[4][2];
  const size_t wsz = (size_t)kWidth * kWidth;
  // layer 0: inp -> act0
  zero(acc);
  accumulate(acc, inp, in_ld, w0, kin, n0);
  epilogue(acc, bias, act0, n0, scratch, lane);
  __syncthreads();
  // layers 1..4: act0 -> act1 -> act0 -> act1 -> act0
  bf16* src = act0;
  bf16* dst = act1;
  for (int l = 1; l <= 4; ++l) {
    zero(acc);
    accumulate(acc, src, kActLd, w_hidden + (l - 1) * wsz, kWidth, n0);
    epilogue(acc, bias + l * kWidth, dst, n0, scratch, lane);
    __syncthreads();
    bf16* t = src;
    src = dst;
    dst = t;
  }
  // layer 5, the skip: inp @ Ws_in + h @ Ws_h in one accumulation
  zero(acc);
  accumulate(acc, inp, in_ld, ws_in, kin, n0);
  accumulate(acc, src, kActLd, w_hidden + 4 * wsz, kWidth, n0);
  epilogue(acc, bias + 5 * kWidth, dst, n0, scratch, lane);
  __syncthreads();
  {
    bf16* t = src;
    src = dst;
    dst = t;
  }
  // layers 6, 7
  for (int l = 6; l <= 7; ++l) {
    zero(acc);
    accumulate(acc, src, kActLd, w_hidden + (l - 1) * wsz, kWidth, n0);
    epilogue(acc, bias + l * kWidth, dst, n0, scratch, lane);
    __syncthreads();
    bf16* t = src;
    src = dst;
    dst = t;
  }

  // heads, float32: warp w takes rows 8 w .. 8 w + 7; lane l sums inputs
  // l, l + 32, ..., then a butterfly of shuffles completes each sum
  for (int rr = 0; rr < kRows / kWarps; ++rr) {
    const int r = warp * (kRows / kWarps) + rr;
    const int row = row0 + r;
    float part[kOut];
#pragma unroll
    for (int j = 0; j < kOut; ++j) part[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < kWidth / 32; ++i) {
      const int k = lane + 32 * i;
      const float h = __bfloat162float(src[r * kActLd + k]);
#pragma unroll
      for (int j = 0; j < kOut; ++j) part[j] += h * wh[k * kOut + j];
    }
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part[j] += __shfl_xor_sync(0xffffffffu, part[j], off);
    }
    if (row < n && lane < kOut) {
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < kOut; ++j)
        if (lane == j) v = part[j] + bh[j];
      if (lane < 3)
        d_xyz[(size_t)row * 3 + lane] = v;
      else if (lane < 7)
        d_rot[(size_t)row * 4 + lane - 3] = v;
      else
        d_scale[(size_t)row * 3 + lane - 7] = v;
    }
  }
}

}  // namespace

// Bytes of dynamic shared memory a block takes at padded input width kin.
extern "C" int trase_deform_mlp_smem(int kin) {
  return (kRows * (kin + kPad) + 2 * kRows * kActLd) * (int)sizeof(bf16) +
         kWarps * 256 * (int)sizeof(float);
}

// C interface for ctypes. emb (n, in_dim) float32; w0 and ws_in (256, kin)
// bf16 with kin = in_dim rounded up to a multiple of 16 (zero columns past
// in_dim); w_hidden (7, 256, 256) bf16 = W1..W4, Ws_h, W6, W7, each
// (out, in) as nn.Linear keeps it; bias (8, 256) float32; wh (256, 10) and
// bh (10,) float32, the heads [d_xyz | d_rot | d_scale]. Returns the
// launch's cudaError_t (0 = success), cudaErrorInvalidValue for shapes the
// kernel does not take.
extern "C" int trase_deform_mlp(const float* emb, int n, int in_dim,
                                int kin, const void* w0, const void* ws_in,
                                const void* w_hidden, const float* bias,
                                const float* wh, const float* bh,
                                float* d_xyz, float* d_rot, float* d_scale,
                                void* stream) {
  if (n <= 0 || in_dim <= 0 || kin < in_dim || kin % 16 != 0 || kin > 256)
    return (int)cudaErrorInvalidValue;
  const int smem = trase_deform_mlp_smem(kin);
  cudaError_t err = cudaFuncSetAttribute(
      deform_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kRows - 1) / kRows;
  deform_mlp_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      emb, n, in_dim, kin, static_cast<const bf16*>(w0),
      static_cast<const bf16*>(ws_in), static_cast<const bf16*>(w_hidden),
      bias, wh, bh, d_xyz, d_rot, d_scale);
  return (int)cudaGetLastError();
}
