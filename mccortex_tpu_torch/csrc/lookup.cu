// Batched hash-bucket probe: (Q, W) kmer keys -> (row index, found).
//
// Replaces: mccortex_tpu/ops/pallas/lookup.py lookup_fused (kernel
// _make_kernel), together with the XLA prologue and epilogue of its wrapper:
// the splitmix64 hash, the bucket, the sentinel test and the final masks
// all happen here, so the kernel reads the query words and the table and
// writes idx and found, nothing else.
//
// Table (built on the host, ops/kernels/lookup.py build_table128): B = 2^b
// rows of 128 uint32 (512 bytes).  A row holds, per bucket, S = 128 / (2W+1)
// slots of each plane [w0_hi x S | w0_lo x S | ... | row_idx x S | pad];
// empty and pad slots are 0xFFFFFFFF in every plane.  bucket(key) =
// splitmix64 fold of the words >> (64 - b).
//
// Bound: device memory latency and bytes.  Each query costs one dependent
// 512-byte row read after its own 8W-byte read, a few dozen integer
// operations and a 5-byte write; the row read is the whole byte bill.
//
// Design: the TPU kernel pipelines 128 row DMAs per wave into VMEM and
// compares a (128, 128) block with lane rolls.  On Hopper one warp owns one
// query: every lane reads the query words (one broadcast transaction), the
// warp reads the bucket row coalesced, 16 bytes per lane, into shared
// memory, and lane l compares slots l and l + 32 (when < S) over all 2W key
// planes.  Store keys are unique, so at most one slot matches; a warp
// ballot says whether one did and a warp max reduction takes its row index
// (the max over matching slots, as the TPU kernel's reduction).  Sentinel
// (all-ones) queries are never found and skip the probe.  Blocks of 8 warps
// keep up to 64 queries in flight per SM to hide the row read's latency.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;          // uint32 per table row
constexpr int kWarps = 8;            // queries per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

template <int W>
__global__ void __launch_bounds__(kWarps * 32)
    lookup_kernel(const uint64_t* __restrict__ queries, long long Q,
                  const uint4* __restrict__ table, int b_bits,
                  int32_t* __restrict__ idx_out,
                  uint8_t* __restrict__ found_out) {
  constexpr int S = kLanes / (2 * W + 1);
  __shared__ uint4 rows[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long qi = (long long)blockIdx.x * kWarps + warp;
  if (qi >= Q) return;  // uniform across the warp

  uint64_t w[W];
  bool valid = false;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    w[i] = queries[qi * W + i];
    valid |= w[i] != ~0ull;
  }
  if (!valid) {  // sentinel query: never found
    if (lane == 0) {
      idx_out[qi] = 0;
      found_out[qi] = 0;
    }
    return;
  }
  uint64_t h = splitmix64(w[0]);  // seed 0
#pragma unroll
  for (int i = 1; i < W; ++i) h = splitmix64(h ^ w[i]);
  const unsigned long long bkt = h >> (64 - b_bits);

  rows[warp][lane] = table[bkt * (kLanes / 4) + lane];
  __syncwarp();
  const uint32_t* row = reinterpret_cast<const uint32_t*>(rows[warp]);

  bool hit = false;
  int best = 0;
#pragma unroll
  for (int s = lane; s < S; s += 32) {
    bool eq = true;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      eq &= row[(2 * i) * S + s] == (uint32_t)(w[i] >> 32);
      eq &= row[(2 * i + 1) * S + s] == (uint32_t)w[i];
    }
    if (eq) {
      hit = true;
      best = max(best, (int)row[2 * W * S + s]);
    }
  }
  const unsigned any = __ballot_sync(kFull, hit);
  best = __reduce_max_sync(kFull, best);
  if (lane == 0) {
    idx_out[qi] = any ? best : 0;
    found_out[qi] = any ? 1 : 0;
  }
}

template <int W>
cudaError_t launch(const void* queries, const void* table, void* idx,
                   void* found, int Q, int b_bits, cudaStream_t st) {
  const int blocks = (Q + kWarps - 1) / kWarps;
  lookup_kernel<W><<<blocks, kWarps * 32, 0, st>>>(
      (const uint64_t*)queries, Q, (const uint4*)table, b_bits,
      (int32_t*)idx, (uint8_t*)found);
  return cudaGetLastError();
}

}  // namespace

// queries: (Q, W) uint64, contiguous.  table: (2^b_bits, 128) uint32,
// contiguous, 16-byte aligned.  idx: Q int32.  found: Q bytes (0/1).
// 1 <= W <= 4, 1 <= b_bits <= 31, Q > 0.
extern "C" int mctx_lookup(const void* queries, const void* table, void* idx,
                           void* found, int Q, int W, int b_bits,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 1: return (int)launch<1>(queries, table, idx, found, Q, b_bits, st);
    case 2: return (int)launch<2>(queries, table, idx, found, Q, b_bits, st);
    case 3: return (int)launch<3>(queries, table, idx, found, Q, b_bits, st);
    case 4: return (int)launch<4>(queries, table, idx, found, Q, b_bits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
