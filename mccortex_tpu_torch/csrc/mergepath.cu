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
//
// Merge level (mctx_mergelevel).  Replaces: the same file's _merge_level
// (splits _splits_batched), one level of the merge tree of sort_planes_mp:
// M records as sorted runs of R become runs of 2R.  The same two passes,
// over many independent pairs of neighbouring runs at once: an output tile
// belongs to one pair and its diagonal search runs inside that pair's two
// runs only.  A short last run or a last run without a partner merges what
// is there, so M needs no padding.  Bound: memory bytes, one read and one
// write of every record per level.  Stable, as above; with the stable tile
// sort of csrc/bitonic.cu under it the tree is a stable sort.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // outputs per block
constexpr int kMaxKeys = 9;               // key planes held in shared memory

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

// Number of A records among the first d merged outputs of A (Ma records)
// and B (Mb records): the merge-path split of diagonal d, A winning ties.
__device__ int diag_split(const int32_t* a, long long lda, int Ma,
                          const int32_t* b, long long ldb, int Mb, int d,
                          int nk) {
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
  return lo;
}

// One block merges the n outputs of one tile: A's records [a0, a1) and B's
// records from b0 on, written to out[0, n) (np planes at stride ldo).
__device__ void merge_tile(const int32_t* __restrict__ a, long long lda,
                           const int32_t* __restrict__ b, long long ldb,
                           int nk, int np, int a0, int a1, int b0, int n,
                           int32_t* __restrict__ out, long long ldo) {
  __shared__ uint32_t sk[kMaxKeys * kTile];
  __shared__ int src[kTile];
  const int na = a1 - a0;
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
      out[p * ldo + j] = s >= 0 ? a[p * lda + a0 + s] : b[p * ldb + b0 + ~s];
    }
  }
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
  split[t] = diag_split(a, lda, Ma, b, ldb, Mb, d, nk);
}

__global__ void mp_merge(const int32_t* __restrict__ a, long long lda, int Ma,
                         const int32_t* __restrict__ b, long long ldb, int Mb,
                         int nk, int np, const int* __restrict__ split,
                         int32_t* __restrict__ out, long long M) {
  const int t = blockIdx.x;
  const long long d0 = (long long)t * kTile;
  const int n = (int)(min(d0 + kTile, M) - d0);
  const int a0 = split[t];
  merge_tile(a, lda, b, ldb, nk, np, a0, split[t + 1], (int)d0 - a0, n,
             out + d0, M);
}

// One level of a merge tree.  x holds runs of R sorted records (the last
// may be shorter); the runs 2q and 2q+1 are pair q, merged into the run q
// of 2R in out.  Every pair owns tpp = ceil(2R / kTile) tiles and tpp + 1
// splits; the tiles past the end of a short last pair are empty.
struct Pair {
  long long base;   // first record of the pair
  int Ma, Mb;       // lengths of its two runs
};

__device__ __forceinline__ Pair pair_of(int q, long long R, long long M) {
  Pair p;
  p.base = (long long)q * 2 * R;
  p.Ma = (int)min(R, M - p.base);
  p.Mb = (int)max(0ll, min(R, M - p.base - R));
  return p;
}

__global__ void ml_partition(const int32_t* __restrict__ x, long long ld,
                             long long M, long long R, int nk, int tpp,
                             int nsplits, int* __restrict__ split) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nsplits) return;
  const Pair p = pair_of(s / (tpp + 1), R, M);
  const int d = (int)min((long long)(s % (tpp + 1)) * kTile,
                         (long long)p.Ma + p.Mb);
  const int32_t* a = x + p.base;
  split[s] = diag_split(a, ld, p.Ma, a + p.Ma, ld, p.Mb, d, nk);
}

__global__ void ml_merge(const int32_t* __restrict__ x, long long ld,
                         long long M, long long R, int nk, int np, int tpp,
                         const int* __restrict__ split,
                         int32_t* __restrict__ out, long long ldo) {
  const int q = blockIdx.x / tpp;
  const int lt = blockIdx.x % tpp;
  const Pair p = pair_of(q, R, M);
  const long long len = (long long)p.Ma + p.Mb;
  const long long d0 = (long long)lt * kTile;
  if (d0 >= len) return;   // the whole block leaves: no barrier is skipped
  const int n = (int)(min(d0 + kTile, len) - d0);
  const int* sp = split + (long long)q * (tpp + 1) + lt;
  const int32_t* a = x + p.base;
  merge_tile(a, ld, a + p.Ma, ld, nk, np, sp[0], sp[1], (int)d0 - sp[0], n,
             out + p.base + d0, ldo);
}

}  // namespace

// a: np planes of Ma at stride lda; b: np planes of Mb at stride ldb;
// out: (np, Ma + Mb) int32; split: ceil((Ma + Mb) / 1024) + 1 ints of
// scratch.  Requires 0 < Ma + Mb < 2**31 and 1 <= nk <= min(np, 9).
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

// x: np planes of M at stride ld, runs of R sorted records; out: np planes
// of M at stride ldo (out != x), runs of 2R; split: ceil(M / 2R) *
// (ceil(2R / 1024) + 1) ints of scratch.  Requires 0 < M < 2**31, R >= 1,
// 1 <= nk <= min(np, 9).  Stable: in every pair the first run wins ties.
extern "C" int mctx_mergelevel(const void* x, void* out, void* split, int M,
                               int R, int nk, int np, int ld, int ldo,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long two_r = 2ll * R;
  const int npairs = (int)((M + two_r - 1) / two_r);
  const int tpp = (int)((two_r + kTile - 1) / kTile);
  const long long nsplits = (long long)npairs * (tpp + 1);
  const long long ntiles = (long long)npairs * tpp;
  if (nsplits >= 1ll << 31) return (int)cudaErrorInvalidValue;
  const int32_t* px = (const int32_t*)x;
  int* sp = (int*)split;
  ml_partition<<<(int)((nsplits + kThreads - 1) / kThreads), kThreads, 0,
                 st>>>(px, ld, M, R, nk, tpp, (int)nsplits, sp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ml_merge<<<(int)ntiles, kThreads, 0, st>>>(px, ld, M, R, nk, np, tpp, sp,
                                             (int32_t*)out, ldo);
  return (int)cudaGetLastError();
}
