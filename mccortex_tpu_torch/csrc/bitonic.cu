// Bitonic sort and merge over 32-bit record planes.
//
// Replaces: mccortex_tpu/ops/pallas/bitonic.py -- the block sort kernel
// (_make_blocksort_kernel) and the tail kernel (_make_tail_kernel), both
// reached through _pcall by sort_planes and merge_planes, and by
// mergepath.sort_planes_mp for its sorted runs.  The cross-tile
// compare-exchange (_xla_butterfly there, plain XLA) is the third kernel
// of this file.  Records are np int32 planes of M; the first nk planes are
// the key, most significant first, compared as uint32 (the sentinel
// 0xFFFFFFFF sorts last; no sign flip is needed).
//
// Bound: memory bytes for every kernel here (each reads its records once
// and writes them once; the compare network itself runs in shared
// memory).  The sort as a whole is bound by its number of passes over
// device memory: with a tile of T records a full sort of M takes one
// block sort, log2(M/T) tails and log2(M/T)*(log2(M/T)+1)/2 butterflies.
//
// Design: a thread block stages the nk key planes of its tile of 2048
// records plus each record's index within the tile in shared memory, runs
// the network on those (keys and index move together), then writes every
// plane coalesced by gathering the source records through the index, so
// shared memory holds (nk + 1) * 8 KB whatever np is.
//   * block sort: the full network, stages 2..T.  Ties break on the source
//     index, so the order is total: an ascending tile equals a stable sort
//     and a descending tile is its exact reverse.  Tiles leave alternately
//     ascending and descending (what the global network wants), or all
//     ascending (what the merge tree of sort_planes_mp wants).  A ragged
//     last tile is padded in shared memory with keys that sort after every
//     record (ascending tiles only).
//   * tail: the substeps of distance T/2..1 of one merge stage in one pass;
//     the direction is one bit of the tile's offset, or ascending at the
//     last stage.  Keys alone are compared: equal keys never swap.
//   * butterfly: one compare-exchange at a distance >= T, in place; a
//     thread owns one pair and swaps all np planes when the keys are out of
//     order.
// Nothing here is atomic: the output is the same from run to run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 2048;    // records per block
constexpr int kMaxKeys = 9;    // key planes staged in shared memory

// the record at i sorts strictly before the record at j
template <bool kTieOnIndex>
__device__ __forceinline__ bool before(const uint32_t* sk, const int* sidx,
                                       int nk, int i, int j) {
  for (int p = 0; p < nk; ++p) {
    const uint32_t x = sk[p * kTile + i];
    const uint32_t y = sk[p * kTile + j];
    if (x != y) return x < y;
  }
  return kTieOnIndex ? sidx[i] < sidx[j] : false;
}

// The substeps j = kk/2 .. 1 of stage kk inside the tile.  For kk < kTile
// the direction of element i is ascending iff (i & kk) == 0; for
// kk == kTile it is last_asc for the whole tile.
template <bool kTieOnIndex>
__device__ void stage(uint32_t* sk, int* sidx, int nk, int kk,
                      bool last_asc) {
  for (int j = kk >> 1; j >= 1; j >>= 1) {
    for (int p = threadIdx.x; p < kTile / 2; p += kThreads) {
      const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
      const int q = i | j;
      const bool asc = kk < kTile ? (i & kk) == 0 : last_asc;
      const bool swap = asc ? before<kTieOnIndex>(sk, sidx, nk, q, i)
                            : before<kTieOnIndex>(sk, sidx, nk, i, q);
      if (swap) {
        for (int w = 0; w < nk; ++w) {
          const uint32_t x = sk[w * kTile + i];
          sk[w * kTile + i] = sk[w * kTile + q];
          sk[w * kTile + q] = x;
        }
        const int s = sidx[i];
        sidx[i] = sidx[q];
        sidx[q] = s;
      }
    }
    __syncthreads();
  }
}

// keys of the tile's n records and their indices into shared memory; the
// slots past n get keys that sort last
__device__ void load_tile(const int32_t* __restrict__ in, long long ld,
                          long long base, int n, int nk, uint32_t* sk,
                          int* sidx) {
  for (int p = 0; p < nk; ++p) {
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      sk[p * kTile + j] =
          j < n ? (uint32_t)in[p * ld + base + j] : 0xFFFFFFFFu;
    }
  }
  for (int j = threadIdx.x; j < kTile; j += kThreads) sidx[j] = j;
  __syncthreads();
}

__device__ void store_tile(const int32_t* __restrict__ in, long long ld_in,
                           int32_t* __restrict__ out, long long ld_out,
                           long long base, int n, int np, const int* sidx) {
  for (int p = 0; p < np; ++p) {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      out[p * ld_out + base + j] = in[p * ld_in + base + sidx[j]];
    }
  }
}

__global__ void bt_blocksort(const int32_t* __restrict__ in, long long ld_in,
                             int32_t* __restrict__ out, long long ld_out,
                             int M, int nk, int np, int all_asc) {
  extern __shared__ uint32_t smem[];  // nk key planes, then the index
  uint32_t* sk = smem;
  int* sidx = (int*)(smem + nk * kTile);
  const long long base = (long long)blockIdx.x * kTile;
  const int n = (int)min((long long)kTile, (long long)M - base);
  load_tile(in, ld_in, base, n, nk, sk, sidx);
  const bool last_asc = all_asc || (blockIdx.x & 1) == 0;
  for (int kk = 2; kk <= kTile; kk <<= 1) {
    stage<true>(sk, sidx, nk, kk, last_asc);
  }
  store_tile(in, ld_in, out, ld_out, base, n, np, sidx);
}

__global__ void bt_tail(const int32_t* __restrict__ in, long long ld_in,
                        int32_t* __restrict__ out, long long ld_out, int nk,
                        int np, int k_log, int final_asc) {
  extern __shared__ uint32_t smem[];  // nk key planes, then the index
  uint32_t* sk = smem;
  int* sidx = (int*)(smem + nk * kTile);
  const long long base = (long long)blockIdx.x * kTile;
  load_tile(in, ld_in, base, kTile, nk, sk, sidx);
  const bool asc = final_asc || ((base >> k_log) & 1) == 0;
  stage<false>(sk, sidx, nk, kTile, asc);
  store_tile(in, ld_in, out, ld_out, base, kTile, np, sidx);
}

__global__ void bt_butterfly(int32_t* __restrict__ x, long long ld,
                             long long half, int nk, int np, int j_log,
                             int k_log, int final_asc) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= half) return;
  const long long j = 1ll << j_log;
  const long long i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
  const long long q = i | j;
  const bool asc = final_asc || ((i >> k_log) & 1) == 0;
  bool swap = false;   // equal keys stay
  for (int w = 0; w < nk; ++w) {
    const uint32_t a = (uint32_t)x[w * ld + i];
    const uint32_t b = (uint32_t)x[w * ld + q];
    if (a != b) {
      swap = asc ? b < a : a < b;
      break;
    }
  }
  if (swap) {
    for (int w = 0; w < np; ++w) {
      const int32_t a = x[w * ld + i];
      x[w * ld + i] = x[w * ld + q];
      x[w * ld + q] = a;
    }
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// in, out: np planes of M at strides ld_in, ld_out (out != in).  Sorts
// every tile of 2048 records on the first nk planes; tile t leaves
// ascending when all_asc or t is even, else descending.  Requires
// 0 < M < 2**31, 1 <= nk <= min(np, 9); M a multiple of 2048 unless every
// tile is ascending.
extern "C" int mctx_bitonic_blocksort(const void* in, void* out, int M,
                                      int nk, int np, int ld_in, int ld_out,
                                      int all_asc, void* stream) {
  if (nk < 1 || nk > kMaxKeys) return (int)cudaErrorInvalidValue;
  const int bytes = (nk + 1) * kTile * 4;
  cudaError_t e = allow_shared(bt_blocksort, bytes);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = (int)(((long long)M + kTile - 1) / kTile);
  bt_blocksort<<<ntiles, kThreads, bytes, (cudaStream_t)stream>>>(
      (const int32_t*)in, ld_in, (int32_t*)out, ld_out, M, nk, np, all_asc);
  return (int)cudaGetLastError();
}

// The substeps of distance 1024..1 of merge stage 2**k_log over every tile
// of in (M a multiple of 2048), written to out (out != in).
extern "C" int mctx_bitonic_tail(const void* in, void* out, int M, int nk,
                                 int np, int ld_in, int ld_out, int k_log,
                                 int final_asc, void* stream) {
  if (nk < 1 || nk > kMaxKeys) return (int)cudaErrorInvalidValue;
  const int bytes = (nk + 1) * kTile * 4;
  cudaError_t e = allow_shared(bt_tail, bytes);
  if (e != cudaSuccess) return (int)e;
  bt_tail<<<M / kTile, kThreads, bytes, (cudaStream_t)stream>>>(
      (const int32_t*)in, ld_in, (int32_t*)out, ld_out, nk, np, k_log,
      final_asc);
  return (int)cudaGetLastError();
}

// One compare-exchange at distance 2**j_log of merge stage 2**k_log over
// x (np planes of M, M a multiple of 2**(j_log + 1)), in place.
extern "C" int mctx_bitonic_butterfly(void* x, int M, int nk, int np, int ld,
                                      int j_log, int k_log, int final_asc,
                                      void* stream) {
  const long long half = (long long)M / 2;
  const int threads = 256;
  const int blocks = (int)((half + threads - 1) / threads);
  bt_butterfly<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)x, ld, half, nk, np, j_log, k_log, final_asc);
  return (int)cudaGetLastError();
}
