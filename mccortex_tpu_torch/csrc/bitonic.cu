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
// Bound: memory bytes for tail and butterfly (each reads its records once
// and writes them once); the tile sort, 66 dependent substeps over a tile
// that fits in a block, is bound by the latency of those substeps.  The
// sort as a whole is bound by its number of passes over
// device memory: with a tile of T records a full sort of M takes one
// block sort, log2(M/T) tails and log2(M/T)*(log2(M/T)+1)/2 butterflies
// (one butterfly less a stage where the tail spans two tiles).
//
// Design: a tile is 2048 records; a block sorts or merges one tile and then
// writes every plane coalesced by gathering the source records through the
// sorted source index, so only keys and an index move through the network,
// whatever np is.
//   * block sort: the full network, stages 2..T, 66 substeps.  Ties break
//     on the source index, so the order is total: an ascending tile equals
//     a stable sort and a descending tile is its exact reverse (any correct
//     sort gives the same output).  Tiles leave alternately ascending and
//     descending (what the global network wants), or all ascending (what
//     the merge tree of sort_planes_mp wants).  A ragged last tile is
//     padded with keys that sort after every record, index included
//     (ascending tiles only).
//     The TPU kernel runs the network over a 131,072-record VMEM block with
//     lane rolls.  Here the tile is bound by latency, not bytes (one read
//     and one write of 120 tiles is 6 MB), so the network stays out of
//     shared memory wherever it can.  For up to 4 key planes (what build
//     sorts at k <= 63) each of 256 threads keeps 8 consecutive records in
//     registers, a record being its key planes packed two to a 64-bit word
//     plus its source index: the 30 substeps of distance 1, 2, 4 are
//     compare-exchanges between a thread's own registers, the 30 of
//     distance 8..128 go through __shfl_xor_sync inside a warp, and only the
//     6 of distance 256..1024 cross warps, through shared memory and two
//     barriers each.  The tile always sorts ascending; a descending tile is
//     written in reverse.  More key planes (up to 9, reached by the mp
//     lookup join) take the network in shared memory that the other two
//     kernels here use: a dispatch on nk, not a fallback.
//   * tail: the substeps of distance S/2..1 of one merge stage in one pass
//     over spans of S = 2048 or 4096 records; the direction is one bit of
//     the span's offset, or ascending at the last stage.  Keys alone are
//     compared: equal keys never swap, so an exchange between two threads is
//     symmetric (each side keeps its own record on equal keys).  Up to 4 key
//     planes: 256 threads keep S/256 records each in registers, as in the
//     tile sort.  A thread first holds the records t, t + 256, ..., read
//     coalesced, so the distances S/2..256 lie between its own registers;
//     one transposition through shared memory gives it S/256 consecutive
//     records, and the distances 128..S/256 go through __shfl_xor_sync, the
//     rest through its registers again: no barrier inside the network but
//     the transposition's.  The payload planes (up to 8; further planes are
//     gathered from device memory) are meanwhile staged in shared memory by
//     asynchronous copies and permuted there on the way out, so a record
//     crosses device memory once each way.  More key planes keep the
//     network in shared memory (spans of 2048).
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

// the tile sort with its network in shared memory: any nk up to kMaxKeys
__global__ void bt_blocksort_shared(const int32_t* __restrict__ in,
                                    long long ld_in,
                                    int32_t* __restrict__ out,
                                    long long ld_out, int M, int nk, int np,
                                    int all_asc) {
  extern __shared__ __align__(16) uint32_t smem[];  // nk key planes, then the index
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

// ---- the tile sort in registers: nk <= 2 * NW key planes -----------------

constexpr int kRegs = 8;                   // records a thread keeps
constexpr int kSortThreads = kTile / kRegs;
constexpr unsigned kFullMask = 0xffffffffu;

// a record in the network: its key planes two to a word, most significant
// first, and its place in the tile before the sort
template <int NW>
struct Rec {
  uint64_t k[NW];
  uint32_t i;
};

template <int NW>
__device__ __forceinline__ bool rec_less(const Rec<NW>& a, const Rec<NW>& b) {
  bool lt = a.i < b.i;
#pragma unroll
  for (int w = NW - 1; w >= 0; --w) {
    lt = a.k[w] < b.k[w] || (a.k[w] == b.k[w] && lt);
  }
  return lt;
}

// lo before hi when asc, hi before lo otherwise (no two records are equal)
template <int NW>
__device__ __forceinline__ void cmpx(Rec<NW>& lo, Rec<NW>& hi, bool asc) {
  if (rec_less(hi, lo) == asc) {
    const Rec<NW> t = lo;
    lo = hi;
    hi = t;
  }
}

// keep the smaller of mine and other when keep_min, else the larger
template <int NW>
__device__ __forceinline__ void keep(Rec<NW>& mine, const Rec<NW>& other,
                                     bool keep_min) {
  if (rec_less(other, mine) == keep_min) mine = other;
}

// The substeps of distance kRegs/2 .. 1 of stage kk, between a thread's own
// records; pos0 = the tile position of its first record.
template <int NW>
__device__ __forceinline__ void reg_substeps(Rec<NW> (&rec)[kRegs], int pos0,
                                             int kk) {
#pragma unroll
  for (int j = kRegs / 2; j >= 1; j >>= 1) {
    if (j < kk) {
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        if ((r & j) == 0) cmpx(rec[r], rec[r | j], ((pos0 + r) & kk) == 0);
      }
    }
  }
}

template <int NW>
__global__ void __launch_bounds__(kSortThreads)
    bt_blocksort_regs(const int32_t* __restrict__ in, long long ld_in,
                      int32_t* __restrict__ out, long long ld_out, int M,
                      int nk, int np, int all_asc) {
  // the cross-warp exchange: word w of the thread t's record r at
  // [w][r * kSortThreads + t]; afterwards sidx holds the sorted source
  // index, position p at [p + p / 32] (no bank conflict either way)
  __shared__ uint64_t sk[NW][kTile];
  __shared__ uint32_t sidx[kTile + kTile / 32];
  const int t = threadIdx.x;
  const int pos0 = t * kRegs;
  const long long base = (long long)blockIdx.x * kTile;
  const int n = (int)min((long long)kTile, (long long)M - base);

  Rec<NW> rec[kRegs];
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const int pos = pos0 + r;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      uint64_t x = ~0ull;                  // past n: sorts last
      if (pos < n) {                       // 2 NW - 2 < nk: plane 2w is a key
        const uint32_t hi = (uint32_t)in[(2 * w) * ld_in + base + pos];
        const uint32_t lo = 2 * w + 1 < nk
            ? (uint32_t)in[(2 * w + 1) * ld_in + base + pos] : 0u;
        x = ((uint64_t)hi << 32) | lo;
      }
      rec[r].k[w] = x;
    }
    rec[r].i = (uint32_t)pos;
  }

  // stages that fit a thread's own records
#pragma unroll
  for (int kk = 2; kk <= kRegs; kk <<= 1) reg_substeps<NW>(rec, pos0, kk);

#pragma unroll 1
  for (int kk = 2 * kRegs; kk <= kTile; kk <<= 1) {
    const bool asc = (pos0 & kk) == 0;     // the same for a thread's records
#pragma unroll 1
    for (int j = kk >> 1; j >= kRegs; j >>= 1) {
      const int d = j / kRegs;             // the partner is thread t ^ d
      const bool keep_min = ((t & d) == 0) == asc;
      if (d < 32) {
#pragma unroll
        for (int r = 0; r < kRegs; ++r) {
          Rec<NW> o;
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            o.k[w] = __shfl_xor_sync(kFullMask, rec[r].k[w], d);
          }
          o.i = __shfl_xor_sync(kFullMask, rec[r].i, d);
          keep(rec[r], o, keep_min);
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRegs; ++r) {
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            sk[w][r * kSortThreads + t] = rec[r].k[w];
          }
          sidx[r * kSortThreads + t] = rec[r].i;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kRegs; ++r) {
          Rec<NW> o;
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            o.k[w] = sk[w][r * kSortThreads + (t ^ d)];
          }
          o.i = sidx[r * kSortThreads + (t ^ d)];
          keep(rec[r], o, keep_min);
        }
        __syncthreads();
      }
    }
    reg_substeps<NW>(rec, pos0, kk);
  }

  // the tile is ascending; an odd tile leaves in reverse unless all_asc
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const int pos = pos0 + r;
    sidx[pos + (pos >> 5)] = rec[r].i;
  }
  __syncthreads();
  const bool desc = !all_asc && (blockIdx.x & 1) != 0;
  for (int p = 0; p < np; ++p) {
    for (int j = t; j < n; j += kSortThreads) {
      const int src = desc ? kTile - 1 - j : j;
      out[p * ld_out + base + j] =
          in[p * ld_in + base + sidx[src + (src >> 5)]];
    }
  }
}

__global__ void bt_tail(const int32_t* __restrict__ in, long long ld_in,
                        int32_t* __restrict__ out, long long ld_out, int nk,
                        int np, int k_log, int final_asc) {
  extern __shared__ __align__(16) uint32_t smem[];  // nk key planes, then the index
  uint32_t* sk = smem;
  int* sidx = (int*)(smem + nk * kTile);
  const long long base = (long long)blockIdx.x * kTile;
  load_tile(in, ld_in, base, kTile, nk, sk, sidx);
  const bool asc = final_asc || ((base >> k_log) & 1) == 0;
  stage<false>(sk, sidx, nk, kTile, asc);
  store_tile(in, ld_in, out, ld_out, base, kTile, np, sidx);
}

// ---- the tail in registers: nk <= 2 * NW key planes -----------------------

constexpr int kTailThreads = 256;
constexpr int kTailStage = 8;              // payload planes staged

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

// a's key sorts strictly before b's (the index is no part of it)
template <int NW>
__device__ __forceinline__ bool key_less(const Rec<NW>& a, const Rec<NW>& b) {
  bool lt = false;
#pragma unroll
  for (int w = NW - 1; w >= 0; --w) {
    lt = a.k[w] < b.k[w] || (a.k[w] == b.k[w] && lt);
  }
  return lt;
}

// lo and hi swap when their keys are strictly out of order
template <int NW>
__device__ __forceinline__ void cmpx_keys(Rec<NW>& lo, Rec<NW>& hi, bool asc) {
  if (asc ? key_less(hi, lo) : key_less(lo, hi)) {
    const Rec<NW> t = lo;
    lo = hi;
    hi = t;
  }
}

// compare-exchanges between a thread's own records r and r | j, for
// j = REGS / 2 .. 1
template <int NW, int REGS>
__device__ __forceinline__ void own_substeps(Rec<NW> (&rec)[REGS], bool asc) {
#pragma unroll
  for (int j = REGS / 2; j >= 1; j >>= 1) {
#pragma unroll
    for (int r = 0; r < REGS; ++r) {
      if ((r & j) == 0) cmpx_keys(rec[r], rec[r | j], asc);
    }
  }
}

template <int NW, int REGS>
__global__ void __launch_bounds__(kTailThreads)
    bt_tail_regs(const int32_t* __restrict__ in, long long ld_in,
                 int32_t* __restrict__ out, long long ld_out, int nk, int np,
                 int nstage, int k_log, int final_asc) {
  constexpr int kSpan = kTailThreads * REGS;
  // position p of the span at p + p / REGS: a thread's consecutive records
  // and the threads' strided ones both spread over the banks
  constexpr int kPadded = kSpan + kTailThreads;
  extern __shared__ __align__(16) uint32_t smem[];
  uint64_t* sk = (uint64_t*)smem;               // NW rows of kPadded
  uint32_t* sidx = smem + 2 * NW * kPadded;     // kPadded
  uint32_t* pay = sidx + kPadded;               // nstage rows of kSpan
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * kSpan;
  const bool asc = final_asc || ((base >> k_log) & 1) == 0;

  // the payload planes on their way into shared memory
  const uint32_t* win = (const uint32_t*)in + base;
  const bool vec = (ld_in & 3) == 0 && ((uintptr_t)win & 15) == 0;
  for (int p = 0; p < nstage; ++p) {
    uint32_t* dst = pay + p * kSpan;
    const uint32_t* src = win + (nk + p) * ld_in;
    if (vec) {
      for (int i = t; i < kSpan / 4; i += kTailThreads) {
        copy16_async((uint4*)dst + i, (const uint4*)src + i);
      }
    } else {
      for (int i = t; i < kSpan; i += kTailThreads) {
        copy4_async(dst + i, src + i);
      }
    }
  }

  // records t, t + 256, ...: the distances kSpan / 2 .. 256 are a thread's own
  Rec<NW> rec[REGS];
#pragma unroll
  for (int r = 0; r < REGS; ++r) {
    const int pos = t + r * kTailThreads;
#pragma unroll
    for (int w = 0; w < NW; ++w) {   // 2 NW - 2 < nk: plane 2w is a key
      const uint32_t hi = win[(2 * w) * ld_in + pos];
      const uint32_t lo = 2 * w + 1 < nk ? win[(2 * w + 1) * ld_in + pos] : 0u;
      rec[r].k[w] = ((uint64_t)hi << 32) | lo;
    }
    rec[r].i = (uint32_t)pos;
  }
  own_substeps<NW, REGS>(rec, asc);

  // transpose: records t * REGS .. t * REGS + REGS - 1
#pragma unroll
  for (int r = 0; r < REGS; ++r) {
    const int pos = t + r * kTailThreads;
    const int at = pos + pos / REGS;
#pragma unroll
    for (int w = 0; w < NW; ++w) sk[w * kPadded + at] = rec[r].k[w];
    sidx[at] = rec[r].i;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < REGS; ++r) {
    const int at = t * REGS + r + t;
#pragma unroll
    for (int w = 0; w < NW; ++w) rec[r].k[w] = sk[w * kPadded + at];
    rec[r].i = sidx[at];
  }

  // distances 128 .. REGS: the partner is lane t ^ d of the warp
#pragma unroll
  for (int d = 128 / REGS; d >= 1; d >>= 1) {
    const bool want_min = ((t & d) == 0) == asc;
#pragma unroll
    for (int r = 0; r < REGS; ++r) {
      Rec<NW> o;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        o.k[w] = __shfl_xor_sync(kFullMask, rec[r].k[w], d);
      }
      o.i = __shfl_xor_sync(kFullMask, rec[r].i, d);
      // strict on both sides: on equal keys each keeps its own
      if (want_min ? key_less(o, rec[r]) : key_less(rec[r], o)) rec[r] = o;
    }
  }
  own_substeps<NW, REGS>(rec, asc);

  // back through shared memory, so that every plane leaves coalesced
  __syncthreads();
#pragma unroll
  for (int r = 0; r < REGS; ++r) {
    const int at = t * REGS + r + t;
#pragma unroll
    for (int w = 0; w < NW; ++w) sk[w * kPadded + at] = rec[r].k[w];
    sidx[at] = rec[r].i;
  }
  copy_wait();
  __syncthreads();
  int32_t* o = out + base;
#pragma unroll
  for (int r = 0; r < REGS; ++r) {
    const int pos = t + r * kTailThreads;
    const int at = pos + pos / REGS;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint64_t x = sk[w * kPadded + at];
      o[(2 * w) * ld_out + pos] = (int32_t)(uint32_t)(x >> 32);
      if (2 * w + 1 < nk) o[(2 * w + 1) * ld_out + pos] = (int32_t)(uint32_t)x;
    }
    const uint32_t s = sidx[at];
    for (int p = nk; p < np; ++p) {
      const uint32_t v =
          p - nk < nstage ? pay[(p - nk) * kSpan + s] : win[p * ld_in + s];
      o[p * ld_out + pos] = (int32_t)v;
    }
  }
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

template <int NW, int REGS>
cudaError_t launch_tail_regs(const int32_t* in, int ld_in, int32_t* out,
                             int ld_out, int M, int nk, int np, int k_log,
                             int final_asc, cudaStream_t st) {
  constexpr int kSpan = kTailThreads * REGS;
  const int nstage = min(np - nk, kTailStage);
  const int bytes =
      ((2 * NW + 1) * (kSpan + kTailThreads) + nstage * kSpan) * 4;
  cudaError_t e = allow_shared(bt_tail_regs<NW, REGS>, bytes);
  if (e != cudaSuccess) return e;
  bt_tail_regs<NW, REGS><<<M / kSpan, kTailThreads, bytes, st>>>(
      in, ld_in, out, ld_out, nk, np, nstage, k_log, final_asc);
  return cudaGetLastError();
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
  const int ntiles = (int)(((long long)M + kTile - 1) / kTile);
  cudaStream_t st = (cudaStream_t)stream;
  if (nk <= 2) {
    bt_blocksort_regs<1><<<ntiles, kSortThreads, 0, st>>>(
        (const int32_t*)in, ld_in, (int32_t*)out, ld_out, M, nk, np, all_asc);
  } else if (nk <= 4) {
    bt_blocksort_regs<2><<<ntiles, kSortThreads, 0, st>>>(
        (const int32_t*)in, ld_in, (int32_t*)out, ld_out, M, nk, np, all_asc);
  } else {
    const int bytes = (nk + 1) * kTile * 4;
    cudaError_t e = allow_shared(bt_blocksort_shared, bytes);
    if (e != cudaSuccess) return (int)e;
    bt_blocksort_shared<<<ntiles, kThreads, bytes, st>>>(
        (const int32_t*)in, ld_in, (int32_t*)out, ld_out, M, nk, np, all_asc);
  }
  return (int)cudaGetLastError();
}

// The substeps of distance span/2..1 of merge stage 2**k_log (at least
// span) over every span of in (M a multiple of span), written to out
// (out != in).  span is 2048 or, for up to 4 key planes, 4096.
extern "C" int mctx_bitonic_tail(const void* in, void* out, int M, int nk,
                                 int np, int ld_in, int ld_out, int k_log,
                                 int final_asc, int span, void* stream) {
  if (nk < 1 || nk > kMaxKeys || nk > np) return (int)cudaErrorInvalidValue;
  if (span != kTile && !(span == 2 * kTile && nk <= 4)) {
    return (int)cudaErrorInvalidValue;
  }
  if (M % span || (1ll << k_log) < span) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* pi = (const int32_t*)in;
  int32_t* po = (int32_t*)out;
  if (nk <= 4) {
    const bool wide = span == 2 * kTile;
    if (nk <= 2) {
      return (int)(wide ? launch_tail_regs<1, 16>(pi, ld_in, po, ld_out, M,
                                                   nk, np, k_log, final_asc,
                                                   st)
                        : launch_tail_regs<1, 8>(pi, ld_in, po, ld_out, M, nk,
                                                 np, k_log, final_asc, st));
    }
    return (int)(wide ? launch_tail_regs<2, 16>(pi, ld_in, po, ld_out, M, nk,
                                                 np, k_log, final_asc, st)
                      : launch_tail_regs<2, 8>(pi, ld_in, po, ld_out, M, nk,
                                               np, k_log, final_asc, st));
  }
  const int bytes = (nk + 1) * kTile * 4;
  cudaError_t e = allow_shared(bt_tail, bytes);
  if (e != cudaSuccess) return (int)e;
  bt_tail<<<M / kTile, kThreads, bytes, st>>>(pi, ld_in, po, ld_out, nk, np,
                                              k_log, final_asc);
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
