// The training steps' update tail in two launches: Adam over every tensor a
// step trains, the densification statistics and the NaN guard's finiteness
// reduction in one (update_tail_kernel), the guard's commit in the second
// (update_commit_kernel).
//
// Replaces no Pallas kernel: trase_tpu leaves this tail (its engine/optim.py
// adam_update and its trainer's guard) to XLA's fusion. The port's plain
// version (engine/trainer.py: _update_plain) launches some 18 elementwise ops a
// trained tensor, one isfinite().all() a guarded tensor and one torch.where a
// written leaf: about 940 ops a GAUSSIAN step, whose launches the host pays
// for. Here the host lays the step's tensors out in one table and the card
// walks it.
//
// Arithmetic: engine/optim.py: adam_update's expressions in its order, in
// float32, each product, sum and quotient rounded on its own (NVCC_FLAGS has
// -fmad=false; division and sqrtf are IEEE), so every output is the plain
// version's bit for bit on the card:
//   mu = b1 m + (1 - b1) g;  nu = b2 v + ((1 - b2) g) g
//   p' = p - (lr (mu / (1 - b1^t))) / (sqrt(nu / (1 - b2^t)) + eps)
// with t the step count read on the device plus one and b^t as powf (what
// torch.pow of a scalar base and a float tensor computes). The wrapper rounds
// the scalars to float32 as PyTorch rounds a Python float (1 - b1 is taken in
// double first). Rows outside the row mask keep their param and moments. The
// densification statistics are models/gaussians.py: add_densification_stats:
// hypotf of the screen-space gradient scaled by W/2 and H/2 added where
// visible & alive, denom + 1, and torch.maximum's NaN-propagating max of the
// radii.
//
// The guard: each block ANDs the finiteness of what it wrote (Adam and
// densify segments) or only read (check segments: the guarded tensors that
// the step does not write, and the loss) with __syncthreads_and, and stores
// false into the one-byte flag if an element failed; the entry point sets the
// flag to true before the launch. Every such store writes the same
// value, so no atomics are needed. The commit reads the flag as every rank
// agreed it: true returns at once; false copies each old leaf over its new
// buffer, which is torch.where(finite, new, old) bit for bit.
//
// Bound: bytes (a few operations a float). At the GAUSSIAN step's table
// (131072 rows, 59 floats a row over six fields, the deform net's 22 tensors,
// the 32 features and their moments checked) chip_smoke.py counts the bytes
// and times both launches.
//
// Design: the table travels in the kernel's parameter block by value (a
// __grid_constant__ struct of 4856 bytes: over the classic 4 KB, under the
// 32764 bytes that CUDA 12.1 allows on sm_70 and later), so there is no
// host-to-device copy of it and no synchronise. It holds every step the port
// builds: the largest deform net (Blender's time net and the 6-DoF heads, 28
// tensors) trained with the six fields is 34 Adam segments, its GAUSSIAN
// step before the deform net checks 89 tensors; the wrapper refuses more. Blocks are handed
// out in proportion to each segment's length, kChunk elements (or rows) a
// block, so the 131072-row fields and the 256-wide deform biases share one
// grid; a block finds its segment by a scan of the segments' first blocks,
// uniform across the block. A thread moves two float4 per stream where the
// segment's pointers are 16-byte aligned, and scalars at a ragged end.
#include <cstdint>

#include <cuda_runtime.h>

// The table's layout, mirrored by ops/update_tail.py (outside the unnamed
// namespace: the C entry points take it, and keep external linkage).
namespace trase_tail {

constexpr int kMaxAdam = 36;
constexpr int kMaxCheck = 96;
constexpr int kThreads = 256;
constexpr int kGroups = 2;                      // float4 groups a thread
constexpr int kChunk = kThreads * 4 * kGroups;  // elements (rows) a block
constexpr int kCommitBlocks = 1024;             // the commit's grid, at most

struct AdamSeg {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  const int32_t* step;
  float* p_out;
  float* m_out;
  float* v_out;
  int32_t* step_out;
  int32_t n;          // elements
  int32_t row_width;  // elements a row of the table's row mask; 0: unmasked
  float lr;
  int32_t block_begin;
};

struct CheckSeg {
  const float* x;
  int32_t n;
  int32_t block_begin;
};

struct DensifySeg {
  const float* g_off;  // (n, 2)
  const bool* visible;
  const bool* alive;
  const float* radii;
  const float* accum;
  const float* denom;
  const float* max_radii;
  float* accum_out;
  float* denom_out;
  float* max_radii_out;
  int32_t n;  // rows
  float half_w;
  float half_h;
  int32_t block_begin;
};

// Blocks [0, adam_end) run Adam segments, [adam_end, densify_end) the
// densification statistics, [densify_end, n_blocks) check segments.
struct Table {
  AdamSeg adam[kMaxAdam];
  CheckSeg check[kMaxCheck];
  DensifySeg densify;
  const bool* row_mask;
  bool* flag;
  float b1, b2, one_minus_b1, one_minus_b2, eps;
  int32_t n_adam, n_check;
  int32_t adam_end, densify_end, n_blocks;
};
static_assert(sizeof(AdamSeg) == 88 && sizeof(CheckSeg) == 16 &&
                  sizeof(DensifySeg) == 96 && sizeof(Table) == 4856,
              "ops/update_tail.py mirrors this layout");

}  // namespace trase_tail

namespace {

using namespace trase_tail;

// the last segment whose first block is at or before block b
template <typename Seg>
__device__ __forceinline__ int find_segment(const Seg* segs, int count, int b) {
  int s = 0;
  while (s + 1 < count && b >= segs[s + 1].block_begin) ++s;
  return s;
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return ((uintptr_t)a & 15) == 0;
}

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

struct AdamScalars {
  float b1, b2, omb1, omb2, eps, lr, bc1, bc2;
};

__device__ __forceinline__ void adam_element(const AdamScalars& c, bool live,
                                             float p, float g, float m,
                                             float v, float& po, float& mo,
                                             float& vo) {
  if (!live) {
    po = p;
    mo = m;
    vo = v;
    return;
  }
  mo = c.b1 * m + c.omb1 * g;
  vo = c.b2 * v + c.omb2 * g * g;
  po = p - c.lr * (mo / c.bc1) / (sqrtf(vo / c.bc2) + c.eps);
}

__device__ bool adam_block(const Table& t, int b) {
  const AdamSeg& s = t.adam[find_segment(t.adam, t.n_adam, b)];
  const int local = b - s.block_begin;
  const int32_t step = *s.step + 1;
  if (local == 0 && threadIdx.x == 0) *s.step_out = step;
  const float tf = (float)step;
  const AdamScalars c{t.b1, t.b2, t.one_minus_b1, t.one_minus_b2, t.eps,
                      s.lr, 1.f - powf(t.b1, tf), 1.f - powf(t.b2, tf)};
  const bool vec = aligned16(s.p) && aligned16(s.g) && aligned16(s.m) &&
                   aligned16(s.v) && aligned16(s.p_out) &&
                   aligned16(s.m_out) && aligned16(s.v_out);
  bool ok = true;
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int64_t i =
        (int64_t)local * kChunk + 4 * ((int64_t)k * kThreads + threadIdx.x);
    if (vec && i + 4 <= s.n) {
      alignas(16) float p[4], g[4], m[4], v[4], po[4], mo[4], vo[4];
      *reinterpret_cast<float4*>(p) = __ldg(reinterpret_cast<const float4*>(s.p + i));
      *reinterpret_cast<float4*>(g) = __ldg(reinterpret_cast<const float4*>(s.g + i));
      *reinterpret_cast<float4*>(m) = __ldg(reinterpret_cast<const float4*>(s.m + i));
      *reinterpret_cast<float4*>(v) = __ldg(reinterpret_cast<const float4*>(s.v + i));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = s.row_width == 0 || t.row_mask[(i + j) / s.row_width];
        adam_element(c, live, p[j], g[j], m[j], v[j], po[j], mo[j], vo[j]);
        ok &= finite(po[j]) & finite(mo[j]) & finite(vo[j]);
      }
      *reinterpret_cast<float4*>(s.p_out + i) = *reinterpret_cast<float4*>(po);
      *reinterpret_cast<float4*>(s.m_out + i) = *reinterpret_cast<float4*>(mo);
      *reinterpret_cast<float4*>(s.v_out + i) = *reinterpret_cast<float4*>(vo);
    } else {
      for (int64_t j = i; j < i + 4 && j < s.n; ++j) {
        const bool live = s.row_width == 0 || t.row_mask[j / s.row_width];
        float po, mo, vo;
        adam_element(c, live, s.p[j], s.g[j], s.m[j], s.v[j], po, mo, vo);
        s.p_out[j] = po;
        s.m_out[j] = mo;
        s.v_out[j] = vo;
        ok &= finite(po) & finite(mo) & finite(vo);
      }
    }
  }
  return ok;
}

__device__ bool densify_block(const Table& t, int b) {
  const DensifySeg& s = t.densify;
  const int64_t base = (int64_t)(b - s.block_begin) * kChunk;
  bool ok = true;
  for (int k = 0; k < kChunk / kThreads; ++k) {
    const int64_t r = base + (int64_t)k * kThreads + threadIdx.x;
    if (r >= s.n) break;
    float a = s.accum[r], d = s.denom[r], mr = s.max_radii[r];
    if (s.visible[r] && s.alive[r]) {
      const float gx = s.g_off[2 * r] * s.half_w;
      const float gy = s.g_off[2 * r + 1] * s.half_h;
      a = a + hypotf(gx, gy);
      d = d + 1.f;
      const float rr = s.radii[r];
      mr = mr != mr ? mr : rr != rr ? rr : fmaxf(mr, rr);
    }
    s.accum_out[r] = a;
    s.denom_out[r] = d;
    s.max_radii_out[r] = mr;
    ok &= finite(a) & finite(d) & finite(mr);
  }
  return ok;
}

__device__ bool check_block(const Table& t, int b) {
  const CheckSeg& s = t.check[find_segment(t.check, t.n_check, b)];
  const int64_t base = (int64_t)(b - s.block_begin) * kChunk;
  const bool vec = aligned16(s.x);
  bool ok = true;
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int64_t i = base + 4 * ((int64_t)k * kThreads + threadIdx.x);
    if (vec && i + 4 <= s.n) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(s.x + i));
      ok &= finite(x.x) & finite(x.y) & finite(x.z) & finite(x.w);
    } else {
      for (int64_t j = i; j < i + 4 && j < s.n; ++j) ok &= finite(s.x[j]);
    }
  }
  return ok;
}

__global__ void __launch_bounds__(kThreads)
    update_tail_kernel(const __grid_constant__ Table t) {
  const int b = blockIdx.x;
  const bool ok = b < t.adam_end      ? adam_block(t, b)
                  : b < t.densify_end ? densify_block(t, b)
                                      : check_block(t, b);
  if (!__syncthreads_and(ok) && threadIdx.x == 0) *t.flag = false;
}

// n 32-bit words from src to dst, the chunk of kChunk words at `base`
__device__ __forceinline__ void copy_chunk(const void* src, void* dst,
                                           int64_t n, int64_t base) {
  const uint32_t* s = static_cast<const uint32_t*>(src);
  uint32_t* d = static_cast<uint32_t*>(dst);
  const bool vec = aligned16(s) && aligned16(d);
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int64_t i = base + 4 * ((int64_t)k * kThreads + threadIdx.x);
    if (vec && i + 4 <= n) {
      *reinterpret_cast<uint4*>(d + i) = __ldg(reinterpret_cast<const uint4*>(s + i));
    } else {
      for (int64_t j = i; j < i + 4 && j < n; ++j) d[j] = s[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    update_commit_kernel(const __grid_constant__ Table t, const bool* agreed) {
  if (*agreed) return;
  for (int b = blockIdx.x; b < t.densify_end; b += gridDim.x) {
    if (b < t.adam_end) {
      const AdamSeg& s = t.adam[find_segment(t.adam, t.n_adam, b)];
      const int64_t base = (int64_t)(b - s.block_begin) * kChunk;
      if (base == 0 && threadIdx.x == 0) *s.step_out = *s.step;
      copy_chunk(s.p, s.p_out, s.n, base);
      copy_chunk(s.m, s.m_out, s.n, base);
      copy_chunk(s.v, s.v_out, s.n, base);
    } else {
      const DensifySeg& s = t.densify;
      const int64_t base = (int64_t)(b - s.block_begin) * kChunk;
      copy_chunk(s.accum, s.accum_out, s.n, base);
      copy_chunk(s.denom, s.denom_out, s.n, base);
      copy_chunk(s.max_radii, s.max_radii_out, s.n, base);
    }
  }
}

bool valid(const Table* t, int64_t table_bytes) {
  return table_bytes == (int64_t)sizeof(Table) && t->n_adam >= 0 &&
         t->n_adam <= kMaxAdam && t->n_check >= 0 && t->n_check <= kMaxCheck &&
         0 <= t->adam_end && t->adam_end <= t->densify_end &&
         t->densify_end <= t->n_blocks;
}

}  // namespace

// The table's first launch, after setting the flag to true. Returns a
// cudaError_t as int (0 on success).
using trase_tail::Table;

extern "C" int trase_update_tail(const Table* table, int64_t table_bytes,
                                 void* stream) {
  if (!valid(table, table_bytes)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(table->flag, 1, 1, st);
  if (e != cudaSuccess) return (int)e;
  if (table->n_blocks == 0) return 0;
  update_tail_kernel<<<table->n_blocks, kThreads, 0, st>>>(*table);
  return (int)cudaGetLastError();
}

// The same table's commit, under the agreed flag.
extern "C" int trase_update_commit(const Table* table, int64_t table_bytes,
                                   const bool* agreed, void* stream) {
  if (!valid(table, table_bytes)) return (int)cudaErrorInvalidValue;
  if (table->densify_end == 0) return 0;
  const int blocks =
      table->densify_end < kCommitBlocks ? table->densify_end : kCommitBlocks;
  update_commit_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*table,
                                                                      agreed);
  return (int)cudaGetLastError();
}
