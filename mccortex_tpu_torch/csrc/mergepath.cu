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
// searches touch O(log M) keys per output tile.
//
// Design: the classic GPU merge path.  Pass 1 binary-searches the
// diagonal of every 1024-output tile boundary (A wins ties: A[i] <= B[j]),
// so each tile owns a disjoint window of A and of B and no record is
// emitted twice.  Pass 2: each block stages its two windows, whole records
// (every plane, up to 16; further planes are gathered from device memory),
// in shared memory by asynchronous copies: 16 bytes a copy where the
// planes' strides keep every plane at one alignment, the window's head and
// tail and every other case 4 bytes a copy; a window sits in its shared
// row at its own address modulo 16 bytes.  Every thread then searches its
// own 4-output diagonal inside the tile and merges its 4 outputs,
// recording each output's source; then the block writes every plane
// coalesced, from shared memory.  A record crosses device memory once each
// way.  With up to 4 key planes the merge keeps its two candidates' keys in
// registers, two planes to a 64-bit word, and reads one record a step; with
// 5 to 9 (the mp lookup join) it compares in shared memory, plane by plane:
// a dispatch on nk.  The searches compare plane by plane and stop at the
// first plane that differs.
//
// Merge level (mctx_mergelevel).  Replaces: the same file's _merge_level
// (splits _splits_batched), the levels of the merge tree of sort_planes_mp:
// M records as sorted runs of R become runs of 2R (or, fused, of R << L).
// A short last run or a last run without a partner merges what is there,
// so M needs no padding.  Bound: memory bytes, one read and one write of
// every record per launch.  Stable; with the stable tile sort of
// csrc/bitonic.cu under it the tree is a stable sort.  Two kernels, one
// launch each:
//   * ml_merge, any R: an output tile belongs to one pair of runs; the
//     block's first two warps find the tile's two diagonals themselves, 32
//     split points a step (3 dependent loads where a binary search over a
//     run of 2048 takes 11), and the block merges the tile as above.  No
//     partition pass and no scratch.
//   * ml_fused, while a group of R << L records fits in one block's shared
//     memory (up to 16,384 records of 3 planes in 227 KB): the block stages
//     its group once, merges it level after level in place (every thread
//     records the sources of its own outputs, then the block permutes one
//     plane at a time through registers) and writes the last level straight
//     to device memory: L levels in one trip.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // outputs per block
constexpr int kMaxKeys = 9;               // key planes
constexpr int kRow = kTile + 8;           // words of a staged plane: both
                                          // windows at their own alignment
constexpr int kStageMax = 16;             // planes a tile stages
constexpr int kFusedThreads = 1024;
constexpr int kFusedMax = 16 * kFusedThreads;   // records of a fused group
constexpr int kSharedMax = 232448;        // bytes a block may ask for
constexpr unsigned kFullMask = 0xffffffffu;

// ---- asynchronous copies into shared memory ------------------------------

__device__ __forceinline__ void copy4_async(uint32_t* dst,
                                            const uint32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void copy16_async(uint4* dst, const uint4* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}

// this thread's asynchronous copies have landed
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.commit_group;" ::);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// count words from src to dst by the whole block.  vec: dst and src are
// congruent modulo 16 bytes, so all but a head and a tail of up to 3 words
// go 16 bytes a copy.
__device__ __forceinline__ void stage_words(uint32_t* dst, const uint32_t* src,
                                            int count, bool vec) {
  const int t = threadIdx.x, nt = blockDim.x;
  int head = count;
  if (vec) head = min(count, (int)((4 - (((uintptr_t)src >> 2) & 3)) & 3));
  const int body = (count - head) >> 2;
  for (int i = t; i < head; i += nt) copy4_async(dst + i, src + i);
  uint4* d4 = (uint4*)(dst + head);
  const uint4* s4 = (const uint4*)(src + head);
  for (int i = t; i < body; i += nt) copy16_async(d4 + i, s4 + i);
  for (int i = head + 4 * body + t; i < count; i += nt) {
    copy4_async(dst + i, src + i);
  }
}

// ---- key compares --------------------------------------------------------

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

// staged record i <= staged record j, plane by plane, most significant
// first: the first plane that differs decides, so most compares read one
// word a side.  NK = 1..4: that many key planes; NK = 0: nk planes.
template <int NK>
__device__ __forceinline__ bool le_shared(const uint32_t* sk, int stride,
                                          int nk, int i, int j) {
  const int n = NK ? NK : nk;
  for (int p = 0; p < n; ++p) {
    const uint32_t x = sk[p * stride + i];
    const uint32_t y = sk[p * stride + j];
    if (x != y) return x < y;
  }
  return true;
}

// the key of a staged record in registers: its NK planes two to a word
template <int NK>
struct Key {
  uint64_t w[(NK + 1) / 2];
};

template <int NK>
__device__ __forceinline__ Key<NK> load_key(const uint32_t* sk, int stride,
                                            int i) {
  Key<NK> k;
#pragma unroll
  for (int w = 0; w < (NK + 1) / 2; ++w) {
    const uint64_t hi = sk[(2 * w) * stride + i];
    const uint32_t lo = 2 * w + 1 < NK ? sk[(2 * w + 1) * stride + i] : 0u;
    k.w[w] = (hi << 32) | lo;
  }
  return k;
}

template <int NK>
__device__ __forceinline__ bool key_le(const Key<NK>& a, const Key<NK>& b) {
  bool le = true;
#pragma unroll
  for (int w = (NK + 1) / 2 - 1; w >= 0; --w) {
    le = a.w[w] < b.w[w] || (a.w[w] == b.w[w] && le);
  }
  return le;
}

// ---- merge-path splits ---------------------------------------------------

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

// The same split, found by a whole warp: each step its lanes test the last
// point of 32 equal parts of [lo, hi), which narrows the range 32-fold.
__device__ int diag_split_warp(const int32_t* a, long long lda, int Ma,
                               const int32_t* b, long long ldb, int Mb, int d,
                               int nk) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - Mb);
  int hi = min(d, Ma);
  while (lo < hi) {
    const int part = (hi - lo + 31) >> 5;
    const long long mid = (long long)lo + (long long)(lane + 1) * part - 1;
    const bool ahead =
        mid < hi && le_global(a, lda, (int)mid, b, ldb, d - (int)mid - 1, nk);
    // the test is true up to the split and false from it on
    const int c = __popc(__ballot_sync(kFullMask, ahead));
    if (c < 32) {
      hi = (int)min((long long)hi,
                    (long long)lo + (long long)(c + 1) * part - 1);
    }
    lo += c * part;
  }
  return lo;
}

// ---- the merge inside shared memory --------------------------------------

// The outputs [dd, dd + cnt) of the merge of the staged records
// [ia0, ia0 + na) and [ib0, ib0 + nb): the place in shared memory of each
// one's source record goes to src[0, cnt).
template <int NK, typename Index>
__device__ __forceinline__ void merge_run(const uint32_t* sk, int stride,
                                          int nk, int ia0, int na, int ib0,
                                          int nb, int dd, int cnt,
                                          Index* src) {
  int lo = max(0, dd - nb);
  int hi = min(dd, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (le_shared<NK>(sk, stride, nk, ia0 + mid, ib0 + dd - mid - 1)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int ai = lo;
  int bi = dd - lo;
  if constexpr (NK == 0) {
    for (int u = 0; u < cnt; ++u) {
      const bool take_a =
          ai < na &&
          (bi >= nb || le_shared<NK>(sk, stride, nk, ia0 + ai, ib0 + bi));
      src[u] = (Index)(take_a ? ia0 + ai++ : ib0 + bi++);
    }
  } else {
    // the two candidates' keys stay in registers: a step reads one record
    Key<NK> ka, kb;
    if (ai < na) ka = load_key<NK>(sk, stride, ia0 + ai);
    if (bi < nb) kb = load_key<NK>(sk, stride, ib0 + bi);
    for (int u = 0; u < cnt; ++u) {
      if (ai < na && (bi >= nb || key_le<NK>(ka, kb))) {
        src[u] = (Index)(ia0 + ai);
        if (++ai < na) ka = load_key<NK>(sk, stride, ia0 + ai);
      } else {
        src[u] = (Index)(ib0 + bi);
        if (++bi < nb) kb = load_key<NK>(sk, stride, ib0 + bi);
      }
    }
  }
}

// One block merges the n outputs of one tile: A's records [a0, a1) and B's
// records from b0 on, written to out[0, n) (np planes at stride ldo).  sm:
// ns rows of kRow words (the first ns planes are staged, ns >= nk), then
// kTile 16-bit source places.
template <int NK>
__device__ void merge_tile(const int32_t* __restrict__ a, long long lda,
                           const int32_t* __restrict__ b, long long ldb,
                           int nk, int np, int ns, int a0, int a1, int b0,
                           int n, int32_t* __restrict__ out, long long ldo,
                           uint32_t* sm) {
  uint16_t* src = (uint16_t*)(sm + ns * kRow);
  const int na = a1 - a0;
  const int nb = n - na;
  const uint32_t* wa = (const uint32_t*)a + a0;
  const uint32_t* wb = (const uint32_t*)b + b0;
  // with strides of whole 16 bytes every plane of a window has one alignment
  const bool vec = ((lda | ldb) & 3) == 0;
  int off_a = 0, off_b = na;
  if (vec) {
    off_a = (int)(((uintptr_t)wa >> 2) & 3);
    off_b = off_a + na;
    off_b += (int)((((uintptr_t)wb >> 2) - off_b) & 3);
  }
  for (int p = 0; p < ns; ++p) {
    stage_words(sm + p * kRow + off_a, wa + p * lda, na, vec);
    stage_words(sm + p * kRow + off_b, wb + p * ldb, nb, vec);
  }
  copy_wait();
  __syncthreads();

  const int dd = min((int)threadIdx.x * kItems, n);
  merge_run<NK>(sm, kRow, nk, off_a, na, off_b, nb, dd, min(kItems, n - dd),
                src + dd);
  __syncthreads();

  for (int p = 0; p < np; ++p) {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int s = src[j];
      uint32_t v;
      if (p < ns) {
        v = sm[p * kRow + s];
      } else {
        v = s < off_b ? wa[p * lda + (s - off_a)] : wb[p * ldb + (s - off_b)];
      }
      out[p * ldo + j] = (int32_t)v;
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

template <int NK>
__global__ void __launch_bounds__(kThreads)
    mp_merge(const int32_t* __restrict__ a, long long lda, int Ma,
             const int32_t* __restrict__ b, long long ldb, int Mb, int nk,
             int np, int ns, const int* __restrict__ split,
             int32_t* __restrict__ out, long long M) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int t = blockIdx.x;
  const long long d0 = (long long)t * kTile;
  const int n = (int)(min(d0 + kTile, M) - d0);
  const int a0 = split[t];
  merge_tile<NK>(a, lda, b, ldb, nk, np, ns, a0, split[t + 1], (int)d0 - a0,
                 n, out + d0, M, smem);
}

// One level of a merge tree.  x holds runs of R sorted records (the last
// may be shorter); the runs 2q and 2q+1 are pair q, merged into the run q
// of 2R in out.  Every pair owns tpp = ceil(2R / kTile) tiles; the tiles
// past the end of a short last pair are empty.
struct Pair {
  long long base;   // first record of the pair
  int Ma, Mb;       // lengths of its two runs
};

__device__ __forceinline__ Pair pair_of(long long q, long long R,
                                        long long M) {
  Pair p;
  p.base = q * 2 * R;
  p.Ma = (int)min(R, M - p.base);
  p.Mb = (int)max(0ll, min(R, M - p.base - R));
  return p;
}

template <int NK>
__global__ void __launch_bounds__(kThreads)
    ml_merge(const int32_t* __restrict__ x, long long ld, long long M,
             long long R, int nk, int np, int ns, int tpp,
             int32_t* __restrict__ out, long long ldo) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int split[2];
  const int q = blockIdx.x / tpp;
  const int lt = blockIdx.x % tpp;
  const Pair p = pair_of(q, R, M);
  const long long len = (long long)p.Ma + p.Mb;
  const long long d0 = (long long)lt * kTile;
  if (d0 >= len) return;   // the whole block leaves: no barrier is skipped
  const int n = (int)(min(d0 + kTile, len) - d0);
  const int32_t* a = x + p.base;
  const int32_t* b = a + p.Ma;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {          // the tile's first diagonal, and its last
    const int s = diag_split_warp(a, ld, p.Ma, b, ld, p.Mb,
                                  (int)d0 + (warp ? n : 0), nk);
    if ((threadIdx.x & 31) == 0) split[warp] = s;
  }
  __syncthreads();
  merge_tile<NK>(a, ld, b, ld, nk, np, ns, split[0], split[1],
                 (int)d0 - split[0], n, out + p.base + d0, ldo, smem);
}

// `levels` levels in one launch: block g owns the group of G = R << levels
// records from g * G on (the last group may be short), staged whole.
// ITEMS records a thread: G <= ITEMS * kFusedThreads.  stride: words of a
// staged plane, a multiple of 4 that is at least G.
template <int NK, int ITEMS>
__global__ void __launch_bounds__(kFusedThreads)
    ml_fused(const int32_t* __restrict__ x, long long ld, long long M, int R,
             int levels, int nk, int np, int stride,
             int32_t* __restrict__ out, long long ldo) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint16_t* src = (uint16_t*)(smem + np * stride);
  const int t = threadIdx.x;
  const int G = R << levels;
  const long long base = (long long)blockIdx.x * G;
  const int n = (int)min((long long)G, M - base);
  const uint32_t* in = (const uint32_t*)x + base;
  const bool vec = (ld & 3) == 0 && ((uintptr_t)in & 15) == 0;
  for (int p = 0; p < np; ++p) {
    stage_words(smem + p * stride, in + p * ld, n, vec);
  }
  copy_wait();
  __syncthreads();

  for (int l = 0; l < levels; ++l) {
    const int r = R << l;
    // the sources of this thread's ITEMS outputs, pair by pair
    const int j1 = min((t + 1) * ITEMS, n);
    for (int j = t * ITEMS; j < j1;) {
      const int pb = j / (2 * r) * (2 * r);
      const int ra = min(r, n - pb);
      const int rb = max(0, min(r, n - pb - r));
      const int seg = min(j1, pb + ra + rb) - j;
      merge_run<NK>(smem, stride, nk, pb, ra, pb + ra, rb, j - pb, seg,
                    src + j);
      j += seg;
    }
    __syncthreads();
    if (l + 1 == levels) break;
    // permute in place, a plane at a time: all read, then all write
    for (int p = 0; p < np; ++p) {
      uint32_t* row = smem + p * stride;
      uint32_t v[ITEMS];
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) {
        const int j = t + u * kFusedThreads;
        if (j < n) v[u] = row[src[j]];
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) {
        const int j = t + u * kFusedThreads;
        if (j < n) row[j] = v[u];
      }
    }
    __syncthreads();
  }
  for (int p = 0; p < np; ++p) {
    const uint32_t* row = smem + p * stride;
    int32_t* o = out + p * ldo + base;
    for (int j = t; j < n; j += kFusedThreads) o[j] = (int32_t)row[src[j]];
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// bytes of shared memory of a tile that stages ns planes
int tile_bytes(int ns) { return ns * kRow * 4 + kTile * 2; }

template <int NK>
cudaError_t launch_mp_merge(const int32_t* a, long long lda, int Ma,
                            const int32_t* b, long long ldb, int Mb, int nk,
                            int np, const int* split, int32_t* out,
                            int ntiles, cudaStream_t st) {
  const int ns = min(np, kStageMax);
  cudaError_t e = allow_shared(mp_merge<NK>, tile_bytes(ns));
  if (e != cudaSuccess) return e;
  mp_merge<NK><<<ntiles, kThreads, tile_bytes(ns), st>>>(
      a, lda, Ma, b, ldb, Mb, nk, np, ns, split, out, (long long)Ma + Mb);
  return cudaGetLastError();
}

template <int NK>
cudaError_t launch_ml_merge(const int32_t* x, long long ld, long long M,
                            long long R, int nk, int np, int tpp,
                            int32_t* out, long long ldo, int ntiles,
                            cudaStream_t st) {
  const int ns = min(np, kStageMax);
  cudaError_t e = allow_shared(ml_merge<NK>, tile_bytes(ns));
  if (e != cudaSuccess) return e;
  ml_merge<NK><<<ntiles, kThreads, tile_bytes(ns), st>>>(
      x, ld, M, R, nk, np, ns, tpp, out, ldo);
  return cudaGetLastError();
}

template <int NK, int ITEMS>
cudaError_t launch_ml_fused(const int32_t* x, long long ld, long long M, int R,
                            int levels, int nk, int np, int32_t* out,
                            long long ldo, cudaStream_t st) {
  const int G = R << levels;
  const int stride = (G + 3) & ~3;
  const int bytes = np * stride * 4 + ((G * 2 + 15) & ~15);
  if (bytes > kSharedMax) return cudaErrorInvalidValue;
  cudaError_t e = allow_shared(ml_fused<NK, ITEMS>, bytes);
  if (e != cudaSuccess) return e;
  const int groups = (int)((M + G - 1) / G);
  ml_fused<NK, ITEMS><<<groups, kFusedThreads, bytes, st>>>(
      x, ld, M, R, levels, nk, np, stride, out, ldo);
  return cudaGetLastError();
}

template <int NK>
cudaError_t launch_ml_fused_items(const int32_t* x, long long ld, long long M,
                                  int R, int levels, int nk, int np,
                                  int32_t* out, long long ldo,
                                  cudaStream_t st) {
  const int G = R << levels;
  if (G <= 4 * kFusedThreads) {
    return launch_ml_fused<NK, 4>(x, ld, M, R, levels, nk, np, out, ldo, st);
  }
  if (G <= 8 * kFusedThreads) {
    return launch_ml_fused<NK, 8>(x, ld, M, R, levels, nk, np, out, ldo, st);
  }
  return launch_ml_fused<NK, 16>(x, ld, M, R, levels, nk, np, out, ldo, st);
}

}  // namespace

// up to 4 key planes are compared packed (NK = nk), more one at a time
#define MCTX_BY_NK(nk, CALL)                 \
  ((nk) == 1   ? CALL(1)                     \
   : (nk) == 2 ? CALL(2)                     \
   : (nk) == 3 ? CALL(3)                     \
   : (nk) == 4 ? CALL(4)                     \
               : CALL(0))

// a: np planes of Ma at stride lda; b: np planes of Mb at stride ldb;
// out: (np, Ma + Mb) int32; split: ceil((Ma + Mb) / 1024) + 1 ints of
// scratch.  Requires 0 < Ma + Mb < 2**31 and 1 <= nk <= min(np, 9).
extern "C" int mctx_mergepath(const void* a, const void* b, void* out,
                              void* split, int Ma, int Mb, int nk, int np,
                              int lda, int ldb, void* stream) {
  if (nk < 1 || nk > kMaxKeys || nk > np) return (int)cudaErrorInvalidValue;
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
#define MCTX_CALL(NK)                                                     \
  launch_mp_merge<NK>(pa, lda, Ma, pb, ldb, Mb, nk, np, sp, (int32_t*)out, \
                      ntiles, st)
  return (int)MCTX_BY_NK(nk, MCTX_CALL);
#undef MCTX_CALL
}

// x: np planes of M at stride ld, runs of R sorted records; out: np planes
// of M at stride ldo (out != x), runs of R << levels.  One kernel launch.
// fused = 0: one level (levels must be 1), any R.  fused = 1: `levels`
// levels by blocks that each stage a group of R << levels records, which
// must be at most 16,384 and fit, every plane, in a block's shared memory
// (else cudaErrorInvalidValue).  Requires 0 < M < 2**31, R >= 1,
// 1 <= nk <= min(np, 9).  Stable: in every pair the first run wins ties.
extern "C" int mctx_mergelevel(const void* x, void* out, int M, int R, int nk,
                               int np, int ld, int ldo, int levels, int fused,
                               void* stream) {
  if (nk < 1 || nk > kMaxKeys || nk > np || R < 1 || levels < 1 ||
      levels > 30) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* px = (const int32_t*)x;
  int32_t* po = (int32_t*)out;
  if (fused) {
    if (((long long)R << levels) > kFusedMax) {
      return (int)cudaErrorInvalidValue;
    }
#define MCTX_CALL(NK) \
  launch_ml_fused_items<NK>(px, ld, M, R, levels, nk, np, po, ldo, st)
    return (int)MCTX_BY_NK(nk, MCTX_CALL);
#undef MCTX_CALL
  }
  if (levels != 1) return (int)cudaErrorInvalidValue;
  const long long two_r = 2ll * R;
  const int tpp = (int)((two_r + kTile - 1) / kTile);
  const long long ntiles = (M + two_r - 1) / two_r * tpp;
  if (ntiles >= 1ll << 31) return (int)cudaErrorInvalidValue;
#define MCTX_CALL(NK) \
  launch_ml_merge<NK>(px, ld, M, R, nk, np, tpp, po, ldo, (int)ntiles, st)
  return (int)MCTX_BY_NK(nk, MCTX_CALL);
#undef MCTX_CALL
}
