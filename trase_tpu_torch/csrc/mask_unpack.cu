// Bit-packed SAM mask stack -> the FEATURE step's padded float32 stack.
//
// Replaces no Pallas kernel: trase_tpu expands a mask file's bits on the
// host (native/trase_io.cpp, unpack_masks_padded) and uploads the float32
// stack. The port's training loop uploads the bits instead (an eighth of a
// byte per mask pixel, a 32nd of the float32 stack's bytes) and expands them
// here, into the (m_max, H, W) stack the contrastive loss reads.
//
// The input is np.packbits' layout of an (n, H, W) bool stack flattened:
// bit i of the stack is bit 7 - i % 8 of byte i / 8 (most significant
// first). Masks need not start on a byte boundary (H W need not be a
// multiple of 8), but the flat index of output float i in the first
// min(n, m_max) rows is bit i itself, so the kernel maps output floats to
// bits without regard to mask boundaries: the first min(n, m_max) H W floats
// are bits, the rest of the m_max H W are zeros (rows past n; with
// n > m_max the first m_max masks are kept, as pad_masks does).
//
// Bound: the writes. 64 x 1200 x 1600 floats are 491.5 MB written and
// 15.4 MB read, 0.151 ms at 3.35 TB/s. Each thread writes two float4 (16
// bytes each, the widest store) from the two nibbles that hold them, and a
// block of 256 threads covers 2048 consecutive floats: store k of the block's
// threads writes 4 KB contiguous, so every warp's store is one run of 512
// bytes. A block reads its 256 bytes of bits through the read-only path,
// each byte by the two threads whose nibbles it holds.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStores = 2;  // float4 stores a thread
constexpr int64_t kChunk = (int64_t)kThreads * kStores * 4;  // floats a block

__device__ __forceinline__ float bit_at(const uint8_t* __restrict__ packed,
                                        int64_t i) {
  return (float)((__ldg(packed + (i >> 3)) >> (7 - (i & 7))) & 1u);
}

__global__ void __launch_bounds__(kThreads)
    unpack_masks_kernel(const uint8_t* __restrict__ packed, int64_t valid,
                        int64_t total, float* __restrict__ out) {
  const int64_t base = (int64_t)blockIdx.x * kChunk;
#pragma unroll
  for (int k = 0; k < kStores; ++k) {
    // i is a multiple of 4: floats i .. i + 3 are one nibble of byte i / 8,
    // the high one when i % 8 == 0
    const int64_t i = base + 4 * ((int64_t)k * kThreads + threadIdx.x);
    if (i + 4 <= valid) {
      const unsigned nib = __ldg(packed + (i >> 3)) >> ((i & 4) ? 0 : 4);
      *reinterpret_cast<float4*>(out + i) =
          make_float4((float)((nib >> 3) & 1u), (float)((nib >> 2) & 1u),
                      (float)((nib >> 1) & 1u), (float)(nib & 1u));
    } else if (i + 4 <= total) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = i + j < valid ? bit_at(packed, i + j) : 0.f;
      *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int64_t j = i; j < total; ++j)
        out[j] = j < valid ? bit_at(packed, j) : 0.f;
    }
  }
}

}  // namespace

// packed: at least n h w bits; out: (m_max, h w) float32, 16-byte aligned.
// Returns a cudaError_t as int (0 on success).
extern "C" int trase_unpack_masks(const uint8_t* packed, int64_t n, int64_t hw,
                                  int64_t m_max, float* out, void* stream) {
  if (n < 0 || hw < 0 || m_max < 0 || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int64_t total = m_max * hw;
  if (total == 0) return 0;
  const int64_t valid = (n < m_max ? n : m_max) * hw;
  const int64_t blocks = (total + kChunk - 1) / kChunk;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  unpack_masks_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      packed, valid, total, out);
  return (int)cudaGetLastError();
}
