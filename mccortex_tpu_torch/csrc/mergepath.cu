// Merge path: merge two sorted record-plane sets in one data pass.
//
// Replaces: mccortex_tpu/ops/pallas/mergepath.py merge_path_planes (kernel
// _make_kernel, splits _splits).  Same contract: A (np planes of Ma) and B
// (np planes of Mb), each sorted in unsigned lexicographic order on its
// first nk planes (the sentinel 0xFFFFFFFF sorts last); out is the np
// planes of the Ma + Mb merged records.  Any lengths are accepted (the TPU
// kernel's block-multiple padding is not needed here).  The merge is
// stable: on equal keys A's records come first, each side in its own order.
//
// Bound: memory bytes.  Every record is read once and written once; the
// binary searches touch O(log M) keys per output tile.
//
// Design: the classic GPU merge path.  Pass 1 binary-searches the
// diagonal of every 1024-output tile boundary (A wins ties: A[i] <= B[j]),
// so each tile owns a disjoint window of A and of B and no record is
// emitted twice.  Pass 2: each block stages its windows' key planes in
// shared memory, every thread searches its own 4-output diagonal inside
// the tile and merges its 4 outputs, recording each output's source; then
// the block writes every plane coalesced, gathering from the source
// records.  Compares are unsigned uint32 on the key planes, so the TPU's
// sign flip is not needed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // outputs per block
constexpr int kMaxKeys = 8;               // key planes held in shared memory

// A[ia] <= B[ib] in unsigned lexicographic order on nk planes
__device__ __forceinline__ bool le_global(const int32_t* a, long long lda,
                                          int ia, const int32_t* b,
                                          long long ldb, int ib, int nk) {
  for (int p = 0; p < nk; ++p) {
    const uint32_t x = (uint32_t)a[p * lda + ia];
    const uint32_t y = (uint32_t)b[p * ldb + ib];
    if (x != y) return x < y;
  }
  return true;
}

__device__ __forceinline__ bool le_shared(const uint32_t* sk, int nk, int i,
                                          int j) {
  for (int p = 0; p < nk; ++p) {
    const uint32_t x = sk[p * kTile + i];
    const uint32_t y = sk[p * kTile + j];
    if (x != y) return x < y;
  }
  return true;
}

// split[t] = number of A records among the first min(t * kTile, Ma + Mb)
// merged outputs, t = 0..ntiles
__global__ void mp_partition(const int32_t* __restrict__ a, long long lda,
                             int Ma, const int32_t* __restrict__ b,
                             long long ldb, int Mb, int nk, int ntiles,
                             int* __restrict__ split) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t > ntiles) return;
  const int d = (int)min((long long)t * kTile, (long long)Ma + Mb);
  int lo = max(0, d - Mb);
  int hi = min(d, Ma);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (le_global(a, lda, mid, b, ldb, d - mid - 1, nk)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  split[t] = lo;
}

__global__ void mp_merge(const int32_t* __restrict__ a, long long lda, int Ma,
                         const int32_t* __restrict__ b, long long ldb, int Mb,
                         int nk, int np, const int* __restrict__ split,
                         int32_t* __restrict__ out, long long M) {
  __shared__ uint32_t sk[kMaxKeys * kTile];
  __shared__ int src[kTile];
  const int t = blockIdx.x;
  const int d0 = t * kTile;
  const int d1 = (int)min((long long)d0 + kTile, (long long)Ma + Mb);
  const int a0 = split[t];
  const int a1 = split[t + 1];
  const int b0 = d0 - a0;
  const int na = a1 - a0;
  const int n = d1 - d0;
  const int nb = n - na;
  // A window at [0, na), B window at [na, n)
  for (int p = 0; p < nk; ++p) {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      sk[p * kTile + j] = j < na ? (uint32_t)a[p * lda + a0 + j]
                                 : (uint32_t)b[p * ldb + b0 + (j - na)];
    }
  }
  __syncthreads();

  const int dd = min((int)threadIdx.x * kItems, n);
  int lo = max(0, dd - nb);
  int hi = min(dd, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (le_shared(sk, nk, mid, na + dd - mid - 1)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int ai = lo;
  int bi = dd - lo;
  for (int u = 0; u < kItems && dd + u < n; ++u) {
    const bool take_a =
        ai < na && (bi >= nb || le_shared(sk, nk, ai, na + bi));
    if (take_a) {
      src[dd + u] = ai++;
    } else {
      src[dd + u] = ~(bi++);
    }
  }
  __syncthreads();

  for (int p = 0; p < np; ++p) {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int s = src[j];
      out[p * M + d0 + j] =
          s >= 0 ? a[p * lda + a0 + s] : b[p * ldb + b0 + ~s];
    }
  }
}

}  // namespace

// a: np planes of Ma at stride lda; b: np planes of Mb at stride ldb;
// out: (np, Ma + Mb) int32; split: ceil((Ma + Mb) / 1024) + 1 ints of
// scratch.  Requires 0 < Ma + Mb < 2**31 and 1 <= nk <= min(np, 8).
extern "C" int mctx_mergepath(const void* a, const void* b, void* out,
                              void* split, int Ma, int Mb, int nk, int np,
                              int lda, int ldb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long M = (long long)Ma + Mb;
  const int ntiles = (int)((M + kTile - 1) / kTile);
  const int32_t* pa = (const int32_t*)a;
  const int32_t* pb = (const int32_t*)b;
  int* sp = (int*)split;
  mp_partition<<<(ntiles + 1 + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      pa, lda, Ma, pb, ldb, Mb, nk, ntiles, sp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mp_merge<<<ntiles, kThreads, 0, st>>>(pa, lda, Ma, pb, ldb, Mb, nk, np, sp,
                                        (int32_t*)out, M);
  return (int)cudaGetLastError();
}
