// The gradient of the FEATURE step's feature smoothing (ops/knn.py:
// smooth_rows): out[i] = mean over the drawn slots s of normed[idx[i, s]],
// so grad[j] = (1 / n_sel) * sum of g[i] over the entries (i, s) with
// idx[i, s] == j and s drawn.
//
// Replaces no Pallas kernel: trase_tpu leaves the gather's gradient to XLA's
// scatter-add, and the port left it to autograd's index backward, which
// sorts the indices and walks each index's duplicates serially. Tied dead
// slots (all at one xyz) name the same few rows: such a hub row takes tens
// of thousands of entries a step, one long serial chain there.
//
// The map's transpose is built once with the map (ops/knn.py:
// transpose_smooth_map): CSR rows rev_ptr over the destination rows, each
// row's entries (source row, slot) in ascending (i, s). A row with more than
// `chunk` entries (a hub) is cut into chunks of `chunk` entries, found at
// the same time.
//
// Bound: bytes. At 262,144 rows x 16 slots x 32 features the map's
// transpose (21 MB), g (33.5 MB) and the gradient (33.5 MB) are 0.026 ms at
// 3.35 TB/s. One warp owns a row or a hub's chunk, its 32 lanes on 32
// features, so a row of g is one 128-byte line. The warp loads 32 entries
// at a time (lane l entry l), tests their slots against the drawn set, and
// walks the drawn ones 8 at a time: 8 independent row loads in flight, then
// 8 adds in entry order. Warps of hub chunks come first in the grid, so the
// longest walks start first. Pass 2 adds each hub's chunk sums in chunk
// order. Every output is summed by one warp in a fixed order: no atomics,
// the same bits on every call.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;   // warps a block
constexpr int kUnroll = 8;  // row loads in flight a warp
constexpr unsigned kFull = 0xffffffffu;

// The drawn slots as a bit mask: slot_on[s] != 0 for s < k, or every slot
// when slot_on is null.
__device__ __forceinline__ uint64_t drawn_slots(const uint8_t* __restrict__ slot_on,
                                                int k, int lane) {
  if (slot_on == nullptr) return ~0ull;
  const unsigned lo = __ballot_sync(kFull, lane < k && __ldg(slot_on + lane));
  const unsigned hi =
      __ballot_sync(kFull, lane + 32 < k && __ldg(slot_on + lane + 32));
  return ((uint64_t)hi << 32) | lo;
}

// Sum of g's rows named by the drawn entries in [begin, end), in entry order.
__device__ __forceinline__ float walk(const float* __restrict__ g, int f, int col,
                                      const int32_t* __restrict__ rev_src,
                                      const uint8_t* __restrict__ rev_slot,
                                      int begin, int end, uint64_t on, int lane) {
  float acc = 0.f;
  for (int base = begin; base < end; base += 32) {
    const int e = base + lane;
    int src = 0;
    bool take = false;
    if (e < end) {
      src = __ldg(rev_src + e);
      take = (on >> __ldg(rev_slot + e)) & 1ull;
    }
    unsigned drawn = __ballot_sync(kFull, take);
    while (drawn) {  // warp-uniform
      int rows[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int b = __ffs(drawn) - 1;  // -1 once drawn is empty
        rows[u] = __shfl_sync(kFull, src, b < 0 ? 0 : b);
        if (b < 0) rows[u] = -1;
        drawn &= drawn - 1;
      }
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = rows[u] >= 0 && col < f ? __ldg(g + (int64_t)rows[u] * f + col) : 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (rows[u] >= 0) acc += v[u];
    }
  }
  return acc;
}

// Warps [0, n_parts) sum a hub chunk each into `partial`; warps n_parts + j
// sum destination row j into grad[j] unless it is a hub.
__global__ void __launch_bounds__(kWarps * 32)
    smooth_rows_bwd_kernel(const float* __restrict__ g, int n_dst, int f,
                           const int32_t* __restrict__ rev_ptr,
                           const int32_t* __restrict__ rev_src,
                           const uint8_t* __restrict__ rev_slot, int chunk,
                           const int32_t* __restrict__ part_begin,
                           const int32_t* __restrict__ part_end, int n_parts,
                           const uint8_t* __restrict__ slot_on, int k, float n_sel,
                           float* __restrict__ partial, float* __restrict__ grad) {
  const int64_t w = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.y * 32 + lane;
  int begin, end;
  float* out;
  bool hub_part;
  if (w < n_parts) {
    begin = __ldg(part_begin + w);
    end = __ldg(part_end + w);
    out = partial + w * f;
    hub_part = true;
  } else if (w < (int64_t)n_parts + n_dst) {
    const int64_t j = w - n_parts;
    begin = __ldg(rev_ptr + j);
    end = __ldg(rev_ptr + j + 1);
    if (end - begin > chunk) return;  // a hub: its chunks and pass 2
    out = grad + j * f;
    hub_part = false;
  } else {
    return;
  }
  const uint64_t on = drawn_slots(slot_on, k, lane);
  const float acc = walk(g, f, col, rev_src, rev_slot, begin, end, on, lane);
  if (col < f) out[col] = hub_part ? acc : acc / n_sel;
}

// Warp h adds hub h's chunk sums in chunk order into its row of grad.
__global__ void __launch_bounds__(kWarps * 32)
    smooth_rows_hub_kernel(const float* __restrict__ partial, int f,
                           const int32_t* __restrict__ hub_rows,
                           const int32_t* __restrict__ hub_part_ptr, int n_hub,
                           float n_sel, float* __restrict__ grad) {
  const int h = blockIdx.x * kWarps + threadIdx.x / 32;
  const int col = blockIdx.y * 32 + (threadIdx.x & 31);
  if (h >= n_hub || col >= f) return;
  const int begin = __ldg(hub_part_ptr + h), end = __ldg(hub_part_ptr + h + 1);
  float acc = 0.f;
  for (int p = begin; p < end; p += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = p + u < end ? __ldg(partial + (int64_t)(p + u) * f + col) : 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p + u < end) acc += v[u];
  }
  grad[(int64_t)__ldg(hub_rows + h) * f + col] = acc / n_sel;
}

}  // namespace

// g: (rows, f) float32, the smoothed rows' gradient; rev_ptr (n_dst + 1),
// rev_src, rev_slot: the map's transpose; part_begin / part_end (n_parts):
// the hub chunks' entry ranges; hub_rows (n_hub), hub_part_ptr (n_hub + 1):
// each hub's row and chunks; slot_on: k flags of the drawn slots, or null for
// every slot; n_sel: the number drawn. partial: (n_parts, f) scratch; grad:
// (n_dst, f), every row written. Returns a cudaError_t as int (0 on success).
extern "C" int trase_smooth_rows_bwd(
    const float* g, int n_dst, int f, const int32_t* rev_ptr,
    const int32_t* rev_src, const uint8_t* rev_slot, int chunk,
    const int32_t* part_begin, const int32_t* part_end, int n_parts,
    const int32_t* hub_rows, const int32_t* hub_part_ptr, int n_hub,
    const uint8_t* slot_on, int k, float n_sel, float* partial, float* grad,
    void* stream) {
  if (n_dst < 0 || f <= 0 || chunk <= 0 || n_parts < 0 || n_hub < 0 || k <= 0 ||
      k > 64 || !(n_sel > 0.f))
    return (int)cudaErrorInvalidValue;
  const unsigned col_blocks = (unsigned)((f + 31) / 32);
  const int64_t warps = (int64_t)n_parts + n_dst;
  if (warps == 0) return 0;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  smooth_rows_bwd_kernel<<<dim3((unsigned)blocks, col_blocks), kWarps * 32, 0,
                           (cudaStream_t)stream>>>(
      g, n_dst, f, rev_ptr, rev_src, rev_slot, chunk, part_begin, part_end,
      n_parts, slot_on, k, n_sel, partial, grad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_hub == 0) return (int)err;
  smooth_rows_hub_kernel<<<dim3((unsigned)((n_hub + kWarps - 1) / kWarps),
                                col_blocks),
                           kWarps * 32, 0, (cudaStream_t)stream>>>(
      partial, f, hub_rows, hub_part_ptr, n_hub, n_sel, grad);
  return (int)cudaGetLastError();
}
