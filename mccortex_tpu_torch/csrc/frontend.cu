// Build front-end for k <= 63: reads -> canonical kmer key planes + edge
// bytes, one pass.
//
// Replaces: mccortex_tpu/ops/pallas/frontend.py records_fused (kernel
// _make_kernel).  Same contract: (B, L) uint8 base codes (4 = N/pad) in;
// NL = 2 (k <= 31) or 4 (k <= 63) int32 key planes, most significant
// first, then one int32 edge-byte plane, each (B, L), out.  Windows that
// do not fit or hold an N get key -1 in every plane and edge 0.
//
// Bound: memory bytes in principle: each window reads 1 byte and writes
// 4 * (NL + 1) bytes, and the packing is a few integer operations per base.
// Measured at the build's 2048 x 150 batches it runs well short of that
// bound (PERF.md): each thread's k-step packing loop is one serial
// dependency chain.  Rolling the window along a row, one base per window,
// is the next step.
//
// Design: one block per tile of whole reads.  The tile's rows are staged
// in shared memory once (one coalesced read of the batch); one thread per
// window packs its k bases straight into NL uint32 limbs (forward strand
// shifted in at the bottom, reverse complement shifted in at the top), so
// no width-doubling passes as on the TPU and no intermediate leaves
// registers.  Neighbouring threads own neighbouring windows of the same
// row, so every plane store is coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindowsPerBlock = 1024;

template <int NL>
__global__ void frontend_kernel(const uint8_t* __restrict__ bases,
                                int32_t* __restrict__ out, int B, int L,
                                int k, int rows) {
  extern __shared__ uint8_t tile[];
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, B - row0);
  const int n = nrows * L;
  const uint8_t* src = bases + (size_t)row0 * L;
  for (int t = threadIdx.x; t < n; t += blockDim.x) tile[t] = src[t];
  __syncthreads();

  const size_t plane = (size_t)B * L;
  const int top_limb = (2 * k - 2) >> 5;
  const int top_bit = (2 * k - 2) & 31;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int r = t / L;
    const int i = t - r * L;
    const uint8_t* rd = tile + r * L;
    bool valid = i + k <= L;
    uint32_t fw[NL], rc[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      fw[j] = 0u;
      rc[j] = 0u;
    }
    if (valid) {
      for (int u = 0; u < k; ++u) {
        const uint32_t c = rd[i + u];
        valid = valid && c < 4u;
        const uint32_t b = c & 3u;
        // forward: value = value << 2 | b
#pragma unroll
        for (int j = NL - 1; j > 0; --j) fw[j] = (fw[j] << 2) | (fw[j - 1] >> 30);
        fw[0] = (fw[0] << 2) | b;
        // reverse complement: value = value >> 2 | comp(b) << (2k - 2)
#pragma unroll
        for (int j = 0; j < NL - 1; ++j) rc[j] = (rc[j] >> 2) | (rc[j + 1] << 30);
        rc[NL - 1] >>= 2;
#pragma unroll
        for (int j = 0; j < NL; ++j) {
          if (j == top_limb) rc[j] |= (3u - b) << top_bit;
        }
      }
    }
    // rc < fw strictly picks the reverse complement as the key
    bool rc_lt = false, eq = true;
#pragma unroll
    for (int j = NL - 1; j >= 0; --j) {
      rc_lt = rc_lt || (eq && rc[j] < fw[j]);
      eq = eq && rc[j] == fw[j];
    }
    const int orient = rc_lt ? 1 : 0;
    int32_t ebyte = 0;
    if (valid) {
      // next window valid <=> this one is and the base after it is ACGT
      if (i + k < L && rd[i + k] < 4) {
        ebyte |= 1 << ((rd[i + k] & 3) + (orient << 2));
      }
      // previous window valid <=> this one is, i > 0, base before is ACGT
      if (i > 0 && rd[i - 1] < 4) {
        ebyte |= 1 << (((3 - (rd[i - 1] & 3)) & 3) + ((1 - orient) << 2));
      }
    }
    const size_t o = (size_t)(row0 + r) * L + i;
#pragma unroll
    for (int p = 0; p < NL; ++p) {
      const uint32_t limb = rc_lt ? rc[NL - 1 - p] : fw[NL - 1 - p];
      out[p * plane + o] = valid ? (int32_t)limb : -1;
    }
    out[NL * plane + o] = ebyte;
  }
}

}  // namespace

// bases: (B, L) uint8; out: (NL + 1, B, L) int32, NL = 2 for k <= 31
// else 4.  Requires 3 <= k <= 63, B * L > 0 and L <= 49152.
extern "C" int mctx_frontend(const void* bases, void* out, int B, int L,
                             int k, void* stream) {
  const int rows = L >= kWindowsPerBlock ? 1 : kWindowsPerBlock / L;
  const int grid = (B + rows - 1) / rows;
  const size_t smem = (size_t)rows * L;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* b = (const uint8_t*)bases;
  int32_t* o = (int32_t*)out;
  if (k <= 31) {
    frontend_kernel<2><<<grid, kThreads, smem, st>>>(b, o, B, L, k, rows);
  } else {
    frontend_kernel<4><<<grid, kThreads, smem, st>>>(b, o, B, L, k, rows);
  }
  return (int)cudaGetLastError();
}
