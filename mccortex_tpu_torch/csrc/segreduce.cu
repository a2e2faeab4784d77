// Segmented reduce + stream compaction over key-sorted record planes.
//
// Replaces: mccortex_tpu/ops/pallas/segreduce.py segreduce_compact_multi
// (kernel _make_kernel).  Same contract: NK int32 key planes sorted in
// unsigned lexicographic order with a sentinel tail (-1 in every key
// plane), NS sum planes and NO or-planes, each (M,).  Out: one record per
// run of equal live keys, compacted to the front: its keys, the run length
// (count), the NS planes summed and the NO planes OR-ed; plus n, the
// number of runs.  The caller fills the outputs with -1 (keys) and 0
// (count, sums, ors) first; slots past n keep that fill.
//
// Bound: memory bytes.  Two reads of the key planes, one read of the value
// planes and a scattered write of the outputs; a handful of integer
// operations per record.  At an epoch's ~250k records the three launches
// and the one-block scan dominate instead (PERF.md).
//
// Design: the TPU grid runs in order and carries the open run from block
// to block; Hopper's blocks run in no order, so there is no carry.  Three
// passes instead:
//   1. each block counts the run starts among its live records;
//   2. one block scans the per-block counts into each block's first output
//      slot (and the total n);
//   3. each block scans its start flags again, so every live record knows
//      its run's slot; the run's first record writes the keys, and every
//      record adds 1 to the count, adds its sums and ORs its or-planes
//      with integer atomics.  Integer atomics are exact in any order, so
//      the result is deterministic; a run that crosses blocks needs no
//      special case.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;         // records per block, one per thread
constexpr int kScanThreads = 1024;

__device__ __forceinline__ bool is_live(const int32_t* keys, long long ld,
                                        int nk, long long i) {
  for (int p = 0; p < nk; ++p) {
    if (keys[p * ld + i] != -1) return true;
  }
  return false;
}

// keys[i] != keys[i - 1], for i > 0
__device__ __forceinline__ bool differs_prev(const int32_t* keys,
                                             long long ld, int nk,
                                             long long i) {
  for (int p = 0; p < nk; ++p) {
    if (keys[p * ld + i] != keys[p * ld + i - 1]) return true;
  }
  return false;
}

// Inclusive scan of one int per thread over a block of N threads.
template <int N>
__device__ int block_inclusive_scan(int v, int* sh) {
  __syncthreads();  // sh may still be read from a previous call
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int off = 1; off < N; off <<= 1) {
    const int t = (int)threadIdx.x >= off ? sh[threadIdx.x - off] : 0;
    __syncthreads();
    sh[threadIdx.x] += t;
    __syncthreads();
  }
  return sh[threadIdx.x];
}

__global__ void seg_count(const int32_t* __restrict__ keys, long long kld,
                          int nk, long long M, int* __restrict__ block_tot) {
  __shared__ int sh[kTile];
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  const int start = (i < M && is_live(keys, kld, nk, i) &&
                     (i == 0 || differs_prev(keys, kld, nk, i)))
                        ? 1
                        : 0;
  block_inclusive_scan<kTile>(start, sh);
  if (threadIdx.x == kTile - 1) block_tot[blockIdx.x] = sh[kTile - 1];
}

// block_tot[j] <- sum of block_tot[0..j) ; *n_out <- sum of all
__global__ void seg_scan_totals(int* __restrict__ block_tot, int nb,
                                int* __restrict__ n_out) {
  __shared__ int sh[kScanThreads];
  int carry = 0;
  for (int base = 0; base < nb; base += kScanThreads) {
    const int j = base + threadIdx.x;
    const int v = j < nb ? block_tot[j] : 0;
    const int incl = block_inclusive_scan<kScanThreads>(v, sh);
    if (j < nb) block_tot[j] = carry + incl - v;
    carry += sh[kScanThreads - 1];
  }
  if (threadIdx.x == 0) *n_out = carry;
}

__global__ void seg_scatter(const int32_t* __restrict__ keys, long long kld,
                            int nk, const int32_t* __restrict__ sums,
                            long long sld, int ns,
                            const int32_t* __restrict__ ors, long long old,
                            int no, long long M,
                            const int* __restrict__ block_off,
                            int32_t* __restrict__ out) {
  __shared__ int sh[kTile];
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  const bool live = i < M && is_live(keys, kld, nk, i);
  const int start =
      (live && (i == 0 || differs_prev(keys, kld, nk, i))) ? 1 : 0;
  const int incl = block_inclusive_scan<kTile>(start, sh);
  if (!live) return;
  const long long slot = (long long)block_off[blockIdx.x] + incl - 1;
  if (start) {
    for (int p = 0; p < nk; ++p) out[p * M + slot] = keys[p * kld + i];
  }
  atomicAdd(&out[nk * M + slot], 1);
  for (int q = 0; q < ns; ++q) {
    const int32_t v = sums[q * sld + i];
    if (v) atomicAdd(&out[(nk + 1 + q) * M + slot], v);
  }
  for (int q = 0; q < no; ++q) {
    const int32_t v = ors[q * old + i];
    if (v) atomicOr(&out[(nk + 1 + ns + q) * M + slot], v);
  }
}

}  // namespace

// keys: nk planes of M at stride kld; sums: ns planes at stride sld; ors:
// no planes at stride old (null when empty).  out: (nk + 1 + ns + no, M)
// int32, pre-filled.  block_tot: ceil(M / 256) ints of scratch.  n_out: one
// int.  Requires M > 0.
extern "C" int mctx_segreduce(const void* keys, const void* sums,
                              const void* ors, void* out, void* block_tot,
                              void* n_out, int nk, int ns, int no, int M,
                              int kld, int sld, int old, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = (M + kTile - 1) / kTile;
  const int32_t* k = (const int32_t*)keys;
  int* tot = (int*)block_tot;
  seg_count<<<nb, kTile, 0, st>>>(k, kld, nk, M, tot);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  seg_scan_totals<<<1, kScanThreads, 0, st>>>(tot, nb, (int*)n_out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  seg_scatter<<<nb, kTile, 0, st>>>(k, kld, nk, (const int32_t*)sums, sld,
                                    ns, (const int32_t*)ors, old, no, M, tot,
                                    (int32_t*)out);
  return (int)cudaGetLastError();
}
