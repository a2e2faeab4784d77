// Segmented reduce + stream compaction over key-sorted record planes, in
// one pass.
//
// Replaces: mccortex_tpu/ops/pallas/segreduce.py segreduce_compact_multi
// (kernel _make_kernel).  Same contract: NK int32 key planes sorted in
// unsigned lexicographic order with a sentinel tail (-1 in every key
// plane), NS sum planes and NO or-planes, each (M,).  Out: one record per
// run of equal live keys, compacted to the front: its keys, the run length
// (count; optional), the NS planes summed (modulo 2^32) and the NO planes
// OR-ed; plus n, the number of runs.  Slots past n hold keys -1 and
// values 0.  A record is live iff some key plane is not -1.
//
// Bound: memory bytes: every input plane read once, every output plane
// written once; a handful of integer operations a record.
//
// Design: the single-pass scan of Merrill and Garland with decoupled
// look-back, as a reduce-by-key.  The TPU grid runs in order and carries
// the open run from block to block; Hopper's blocks run in no fixed order,
// so each block (a tile of 2048 records, 8 a thread: the key planes and the
// first two value planes loaded at once, the values held in registers, so
// a tile waits on one trip to device memory) instead publishes a
// descriptor in a scratch buffer: its count of run starts and the values
// of the run still open at its end, first as its own aggregate and then,
// once it knows the tiles before it, as an inclusive prefix.  A
// descriptor is one 16-byte word (state, count, the first two values),
// stored and loaded by single 16-byte accesses, so a reader needs no fence
// for it; more value planes go to a side buffer written before the
// descriptor, behind a fence.  A block learns its exclusive prefix by
// looking back over its predecessors' descriptors (one warp, 32 tiles a
// step, nearest first) until it meets an inclusive prefix; a tile with no
// run start passes the open run on.  A step is one round trip to L2.
// Inside the tile the start flags and values go through one segmented
// scan, in the thread, then by warp shuffles, then across warps in shared
// memory, with the combining operator (f1, v1) + (f2, v2) = (f1 | f2, f2 ?
// v2 : v1 + v2) (OR for the or-planes); its total is the tile's
// aggregate.  The thread that holds a run's last live record stages the
// run once in shared memory: its keys (the record's own, taken again from
// the cache lines the thread loaded them from), its scanned values; the
// tile's runs take consecutive slots, so each output plane then leaves in
// one coalesced pass.  No atomics touch the outputs, and each key plane is
// read from device memory once.  The descriptors carry a generation stamp,
// so the scratch needs no reset between calls; a second, small kernel
// fills the slots [n, M) after reading n on the device.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                  // records a thread
constexpr int kTile = kThreads * kItems;   // records a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                 // value planes a reduction round
constexpr int kRegPlanes = 2;              // value planes held in registers
constexpr int kLook = 1;                   // descriptors a lane, a step
constexpr int kWindow = 32 * kLook;        // tiles a look-back step
constexpr int kStage = kTile + kTile / 32;  // a plane's slots, padded
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kAggregate = 1, kPrefix = 2;   // descriptor state

struct Args {
  const int32_t* keys;
  const int32_t* sums;
  const int32_t* ors;
  int32_t* out;            // (P, M) rows: keys, [count], sums, ors
  uint4* desc;             // a tile: generation << 2 | state, starts, v0, v1
  int32_t* extra;          // a tile: values 2.. of the aggregate, then of
                           // the inclusive prefix
  int32_t* n_out;
  long long kld, sld, old, M;
  int nk, ns, no, count;   // count: 1 if the count plane is written
  uint32_t gen;
};

// one descriptor, read or written by a single 16-byte access
__device__ __forceinline__ uint4 ld_desc(const uint4* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ void st_desc(uint4* p, uint4 v) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

__device__ __forceinline__ int32_t combine(int32_t a, int32_t b, bool is_or) {
  return is_or ? (a | b) : (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t warp_reduce(int32_t v, bool is_or) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v = combine(v, __shfl_xor_sync(kFull, v, d), is_or);
  }
  return v;
}

// kItems consecutive values of one plane from record r0; records past M
// read as `fill`.  16-byte loads where the plane is aligned.
__device__ __forceinline__ void load_items(const int32_t* plane, long long r0,
                                           long long M, int32_t fill,
                                           int32_t (&v)[kItems]) {
  const int32_t* p = plane + r0;
  if (r0 + kItems <= M && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    v[0] = (int32_t)a.x; v[1] = (int32_t)a.y; v[2] = (int32_t)a.z;
    v[3] = (int32_t)a.w; v[4] = (int32_t)b.x; v[5] = (int32_t)b.y;
    v[6] = (int32_t)b.z; v[7] = (int32_t)b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = r0 + j < M ? __ldg(p + j) : fill;
  }
}

// value plane q (0 <= q < NV): the count, then the sums, then the ors
__device__ __forceinline__ const int32_t* value_plane(const Args& a, int q) {
  q -= a.count;
  return q < a.ns ? a.sums + q * a.sld : a.ors + (q - a.ns) * a.old;
}

// the values of plane q >= kRegPlanes (never the count) for the thread's
// records; 0 where not live
__device__ __forceinline__ void load_values(const Args& a, int q,
                                            long long r0, uint32_t live,
                                            int32_t (&v)[kItems]) {
  load_items(value_plane(a, q), r0, a.M, 0, v);
#pragma unroll
  for (int j = 0; j < kItems; ++j) v[j] = ((live >> j) & 1) ? v[j] : 0;
}

__device__ __forceinline__ int32_t ld_volatile(const int32_t* p) {
  return *(const volatile int32_t*)p;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = min(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// value q of a descriptor read at tile pt: the first two in the word,
// the others in the side buffer (xs of them a half)
__device__ __forceinline__ int32_t desc_value(const Args& a, uint4 d, int q,
                                              int pt, int xs) {
  if (q == 0) return (int32_t)d.z;
  if (q == 1) return (int32_t)d.w;
  const int half = (d.x & 3) == kPrefix ? xs : 0;
  return ld_volatile(a.extra + (size_t)pt * 2 * xs + half + q - 2);
}

// the warp's inclusive segmented scan of (f, v): f = a run starts in the
// lane's records, v = the values after its last start (all, if none)
__device__ __forceinline__ int32_t warp_seg_scan(bool f, int32_t v,
                                                 bool is_or, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t tv = __shfl_up_sync(kFull, v, d);
    const bool tf = __shfl_up_sync(kFull, (int)f, d) != 0;
    if (lane >= d) {
      v = f ? v : combine(tv, v, is_or);
      f = f || tf;
    }
  }
  return v;
}

// the values after the last start among a thread's records (all, if none)
__device__ __forceinline__ int32_t thread_agg(const int32_t (&v)[kItems],
                                              uint32_t start, bool is_or) {
  int32_t agg = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    agg = ((start >> j) & 1) ? v[j] : combine(agg, v[j], is_or);
  }
  return agg;
}

// the stage index of a tile's i-th written slot: a word of padding every
// 32, so that threads whose slots lie kItems apart hit distinct banks
__device__ __forceinline__ int staged(int i) { return i + (i >> 5); }

// run values through a thread's records from `run` (the value entering
// them), staged at each run's end (slot0: the tile's slot of the run open
// before the thread's records)
__device__ __forceinline__ void stage_runs(int32_t* stage, int32_t run,
                                           const int32_t (&v)[kItems],
                                           uint32_t start, uint32_t end,
                                           int slot0, bool is_or) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    run = ((start >> j) & 1) ? v[j] : combine(run, v[j], is_or);
    if ((end >> j) & 1) {
      stage[staged(slot0 + __popc(start & ((2u << j) - 1)))] = run;
    }
  }
}

// Any number of key planes; a run's writer reads its record's keys again
// (from cache).  The first kRegPlanes value planes are loaded with the
// keys and held in registers; further planes are read in a pass of their
// own before the look-back (only the tile's open run) and again after it
// (from cache).
__global__ void __launch_bounds__(kThreads) seg_kernel(Args a) {
  // dynamic: 2 * NV words (exclusive carry, aggregate), then the stage of
  // one output plane's slots (kStage words)
  extern __shared__ uint32_t smem[];
  __shared__ int32_t s_part[kWarps][kChunk];
  __shared__ int32_t s_wval[kRegPlanes + 2][kWarps];   // then starts, ends
  __shared__ uint32_t s_wflag[kWarps];
  __shared__ int32_t s_wlast[kWarps];
  __shared__ int32_t s_cexcl, s_contin;

  const int nk = a.nk;
  const int nv = a.count + a.ns + a.no;
  const int nr = min(nv, kRegPlanes);     // value planes in registers
  int32_t* s_carry = reinterpret_cast<int32_t*>(smem);
  int32_t* s_agg = s_carry + nv;
  int32_t* stage = s_agg + nv;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long M = a.M;
  const long long base = (long long)tile * kTile;
  const long long r0 = base + (long long)tid * kItems;

  // 1. every load first: the register value planes, then the key planes,
  // which give the live records and those whose key differs from the
  // record before (bit j: record r0 + j)
  int32_t vr[kRegPlanes][kItems];
#pragma unroll
  for (int q = 0; q < kRegPlanes; ++q) {
    if (q < nr && q >= a.count) load_items(value_plane(a, q), r0, M, 0, vr[q]);
  }
  uint32_t live = 0, diff = r0 == 0 ? 1u : 0u;
  bool next_live = false, next_diff = false;     // record r0 + kItems
#pragma unroll
  for (int p = 0; p < nk; ++p) {
    const int32_t* plane = a.keys + p * a.kld;
    int32_t v[kItems];
    load_items(plane, r0, M, -1, v);
    int32_t prev = __shfl_up_sync(kFull, v[kItems - 1], 1);
    int32_t next = __shfl_down_sync(kFull, v[0], 1);
    if (lane == 0) prev = r0 > 0 && r0 - 1 < M ? __ldg(plane + r0 - 1) : v[0];
    if (lane == 31) next = r0 + kItems < M ? __ldg(plane + r0 + kItems) : -1;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      live |= (uint32_t)(v[j] != -1) << j;
      diff |= (uint32_t)(v[j] != (j ? v[j - 1] : prev)) << j;
    }
    next_live |= next != -1;
    next_diff |= next != v[kItems - 1];
  }
  const uint32_t start = live & diff;
  // a run goes on past record j iff record j + 1 is live and no start
  const uint32_t top = 1u << (kItems - 1);
  const uint32_t cont = ((live >> 1) | (next_live ? top : 0u)) &
                        ~((start >> 1) | (next_live && next_diff ? top : 0u));
  const uint32_t end = live & ~cont;
  // the count plane is the live flags; other values count where live
#pragma unroll
  for (int q = 0; q < kRegPlanes; ++q) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool lj = (live >> j) & 1;
      vr[q][j] = q < a.count ? (int32_t)lj : (lj ? vr[q][j] : 0);
    }
  }

  // 2. one block scan: the start counts, the tile's last start, and the
  // segmented scan of each register plane
  const int c = __popc(start);
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  const int my_last = start ? tid * kItems + 31 - __clz((int)start) : -1;
  int wl = my_last;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) wl = max(wl, __shfl_xor_sync(kFull, wl, d));
  const unsigned wstarts = __ballot_sync(kFull, start != 0);
  const bool ef = (wstarts & ((1u << lane) - 1)) != 0;   // a start before
  int32_t ev[kRegPlanes];                    // lane exclusive values
#pragma unroll
  for (int q = 0; q < kRegPlanes; ++q) {
    if (q >= nr) continue;
    const bool is_or = q >= a.count + a.ns;
    const int32_t iv = warp_seg_scan(start != 0, thread_agg(vr[q], start,
                                                            is_or),
                                     is_or, lane);
    ev[q] = __shfl_up_sync(kFull, iv, 1);
    if (lane == 0) ev[q] = 0;
    if (lane == 31) s_wval[q][warp] = iv;
  }
  int ends = __popc(end);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) ends += __shfl_xor_sync(kFull, ends, d);
  if (lane == 31) s_wval[kRegPlanes][warp] = incl;
  if (lane == 0) {
    s_wval[kRegPlanes + 1][warp] = ends;
    s_wflag[warp] = wstarts != 0;
    s_wlast[warp] = wl;
  }
  // the tile's first record goes on with a run from the tile before
  if (tid == 0) s_contin = (live & ~start & 1u) ? 1 : 0;
  __syncthreads();
  int local_base = incl - c, tile_cnt = 0, last = -1, tile_ends = 0;
  bool fin = ef;                     // a start in the tile before the lane
  int32_t vin[kRegPlanes];           // the values entering the lane
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      local_base += s_wval[kRegPlanes][w];
      fin = fin || s_wflag[w];
    }
    tile_cnt += s_wval[kRegPlanes][w];
    tile_ends += s_wval[kRegPlanes + 1][w];
    last = max(last, s_wlast[w]);
  }
#pragma unroll
  for (int q = 0; q < kRegPlanes; ++q) {
    if (q >= nr) continue;
    const bool is_or = q >= a.count + a.ns;
    int32_t in = 0, agg = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int32_t x = s_wval[q][w];
      if (w < warp) in = s_wflag[w] ? x : combine(in, x, is_or);
      agg = s_wflag[w] ? x : combine(agg, x, is_or);
    }
    vin[q] = ef ? ev[q] : combine(in, ev[q], is_or);
    if (tid == 0) s_agg[q] = agg;    // the open run at the tile's end
  }

  // 3. planes past the registers: their share of the tile's aggregate,
  // over the records from the tile's last start on
  const long long tail = base + (last >= 0 ? last : 0);
  const int xs = nv > 2 ? nv - 2 : 0;
  int32_t* my_extra = a.extra + (size_t)tile * 2 * xs + (tile == 0 ? xs : 0);
  if (nv > kRegPlanes) {
    uint32_t tmask = live;
    if (r0 + kItems <= tail) {
      tmask = 0;
    } else if (r0 < tail) {
      tmask &= ~0u << (int)(tail - r0);
    }
    const bool warp_in_tail = __any_sync(kFull, tmask != 0);
    for (int q0 = kRegPlanes; q0 < nv; q0 += kChunk) {
      const int qn = min(kChunk, nv - q0);
      for (int qq = 0; qq < qn; ++qq) {
        const int q = q0 + qq;
        const bool is_or = q >= a.count + a.ns;
        int32_t s = 0;
        if (warp_in_tail) {
          if (tmask) {
            int32_t v[kItems];
            load_values(a, q, r0, tmask, v);
#pragma unroll
            for (int j = 0; j < kItems; ++j) s = combine(s, v[j], is_or);
          }
          s = warp_reduce(s, is_or);
        }
        if (lane == 0) s_part[warp][qq] = s;
      }
      __syncthreads();
      if (tid < qn) {
        const int q = q0 + tid;
        const bool is_or = q >= a.count + a.ns;
        int32_t s = 0;
        for (int w = 0; w < kWarps; ++w) s = combine(s, s_part[w][tid], is_or);
        s_agg[q] = s;
        my_extra[q - 2] = s;
        __threadfence();
      }
      __syncthreads();
    }
  }

  // tile 0 knows its inclusive prefix at once
  if (tid == 0) {
    st_desc(a.desc + tile,
            make_uint4((a.gen << 2) | (tile == 0 ? kPrefix : kAggregate),
                       (uint32_t)tile_cnt, nv > 0 ? (uint32_t)s_agg[0] : 0u,
                       nv > 1 ? (uint32_t)s_agg[1] : 0u));
    if (tile == 0) {
      s_cexcl = 0;
      if (gridDim.x == 1) *a.n_out = tile_cnt;
    }
  }

  // 4. look-back (warp 0): the exclusive start count, and the values of
  // the run open where this tile begins.  Position w = lane + 32 j of a
  // step is tile pred - w, nearest first.
  if (tile > 0 && warp == 0) {
    for (int q = lane; q < nv; q += 32) s_carry[q] = 0;
    __syncwarp();
    int excl = 0;
    bool vals_done = false;
    for (int pred = tile - 1;; pred -= kWindow) {
      uint4 d[kLook];
#pragma unroll
      for (int j = 0; j < kLook; ++j) {   // before tile 0: a stop
        const int pt = pred - lane - 32 * j;
        d[j] = pt >= 0 ? ld_desc(a.desc + pt)
                       : make_uint4((a.gen << 2) | kPrefix, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < kLook; ++j) {
        const int pt = pred - lane - 32 * j;
        while ((d[j].x >> 2) != a.gen || (d[j].x & 3) == 0) {
          d[j] = ld_desc(a.desc + pt);
        }
      }
      if (xs) __threadfence();     // the side buffer was written before
      int mine = kWindow;            // nearest inclusive prefix
#pragma unroll
      for (int j = kLook - 1; j >= 0; --j) {
        if ((d[j].x & 3) == kPrefix) mine = lane + 32 * j;
      }
      const int pfx = warp_min(mine);
      const int p = pfx < kWindow ? pfx : kWindow - 1;   // positions 0..p
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < kLook; ++j) {
        if (lane + 32 * j <= p) cnt += (int)d[j].y;
      }
#pragma unroll
      for (int dd = 16; dd > 0; dd >>= 1) cnt += __shfl_xor_sync(kFull, cnt, dd);
      excl += cnt;
      if (!vals_done) {
        // the values come from the tiles after the nearest one with a
        // start (that one's open run included), or back to the prefix
        int mine_s = kWindow;
#pragma unroll
        for (int j = kLook - 1; j >= 0; --j) {
          if (lane + 32 * j <= p && d[j].y > 0) mine_s = lane + 32 * j;
        }
        const int st = warp_min(mine_s);
        const int s = st < kWindow ? st : p;
        for (int q = 0; q < nv; ++q) {
          const bool is_or = q >= a.count + a.ns;
          int32_t v = 0;
#pragma unroll
          for (int j = 0; j < kLook; ++j) {
            if (lane + 32 * j <= s) {
              v = combine(v, desc_value(a, d[j], q, pred - lane - 32 * j, xs),
                          is_or);
            }
          }
          v = warp_reduce(v, is_or);
          if (lane == 0) s_carry[q] = combine(s_carry[q], v, is_or);
        }
        vals_done = st < kWindow || pfx < kWindow;
      }
      if (pfx < kWindow) break;
    }
    __syncwarp();
    // publish the inclusive prefix
    int32_t* inc = a.extra + (size_t)tile * 2 * xs + xs;
    for (int q = 2 + lane; q < nv; q += 32) {
      inc[q - 2] = tile_cnt ? s_agg[q]
                            : combine(s_carry[q], s_agg[q],
                                      q >= a.count + a.ns);
    }
    if (xs) __threadfence();
    __syncwarp();
    if (lane == 0) {
      uint32_t v[2] = {0u, 0u};
      for (int q = 0; q < nv && q < 2; ++q) {
        v[q] = (uint32_t)(tile_cnt ? s_agg[q]
                                   : combine(s_carry[q], s_agg[q],
                                             q >= a.count + a.ns));
      }
      st_desc(a.desc + tile, make_uint4((a.gen << 2) | kPrefix,
                                        (uint32_t)(excl + tile_cnt), v[0],
                                        v[1]));
      s_cexcl = excl;
      if (tile == (int)gridDim.x - 1) *a.n_out = excl + tile_cnt;
    }
  } else if (tile == 0) {
    for (int q = tid; q < nv; q += kThreads) s_carry[q] = 0;
  }
  __syncthreads();
  // the tile's runs end at slots s_lo .. s_lo + tile_ends - 1: each plane
  // is staged in shared memory by the threads that end the runs, then
  // written out in one coalesced pass
  const int s_lo = s_cexcl - s_contin;
  const int slot0 = local_base - 1 + s_contin;   // + starts up to record j
  auto flush = [&](int row) {
    __syncthreads();
    int32_t* o = a.out + (long long)row * M + s_lo;
    for (int i = tid; i < tile_ends; i += kThreads) o[i] = stage[staged(i)];
    __syncthreads();
  };

  // 5. each run's keys and values, staged by the thread with its last
  // live record
#pragma unroll
  for (int p = 0; p < nk; ++p) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if ((end >> j) & 1) {
        stage[staged(slot0 + __popc(start & ((2u << j) - 1)))] =
            __ldg(a.keys + p * a.kld + r0 + j);
      }
    }
    flush(p);
  }
#pragma unroll
  for (int q = 0; q < kRegPlanes; ++q) {
    if (q >= nr) continue;
    const bool is_or = q >= a.count + a.ns;
    stage_runs(stage, fin ? vin[q] : combine(s_carry[q], vin[q], is_or),
               vr[q], start, end, slot0, is_or);
    flush(nk + q);
  }

  // 6. the planes past the registers, one at a time: the segmented scan
  for (int q = kRegPlanes; q < nv; ++q) {
    const bool is_or = q >= a.count + a.ns;
    int32_t v[kItems];
    load_values(a, q, r0, live, v);
    const int32_t iv = warp_seg_scan(start != 0, thread_agg(v, start, is_or),
                                     is_or, lane);
    int32_t lv = __shfl_up_sync(kFull, iv, 1);
    if (lane == 0) lv = 0;
    if (lane == 31) s_wval[0][warp] = iv;
    __syncthreads();
    int32_t run = s_carry[q];
    for (int w = 0; w < warp; ++w) {
      run = s_wflag[w] ? s_wval[0][w] : combine(run, s_wval[0][w], is_or);
    }
    stage_runs(stage, ef ? lv : combine(run, lv, is_or), v, start, end,
               slot0, is_or);
    flush(nk + q);
  }
}

// slots [n, M) of every plane: keys -1, values 0
__global__ void seg_fill(int32_t* __restrict__ out, int planes, int nk,
                         long long M, const int32_t* __restrict__ n_in) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = *n_in + (long long)blockIdx.x * blockDim.x +
                     threadIdx.x;
       i < M; i += step) {
    for (int p = 0; p < planes; ++p) out[p * M + i] = p < nk ? -1 : 0;
  }
}

}  // namespace

// keys: nk planes of M at stride kld; sums: ns planes at stride sld; ors:
// no planes at stride old (null when empty).  out: (nk + count + ns + no,
// M) int32.  With tiles = ceil(M / 2048) and nv = count + ns + no: desc,
// tiles 16-byte descriptors (16-byte aligned), each of an older generation
// than gen (0 < gen < 2**30); extra, tiles * 2 * max(nv - 2, 0) ints.
// n_out: one int.  Requires 0 < M < 2**31.  Launches the reduce and the
// fill of the slots past n.
extern "C" int mctx_segreduce(const void* keys, const void* sums,
                              const void* ors, void* out, void* desc,
                              void* extra, void* n_out, int nk, int ns,
                              int no, int count, int M, int kld, int sld,
                              int old, int gen, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (M + kTile - 1) / kTile;
  Args a;
  a.keys = (const int32_t*)keys;
  a.sums = (const int32_t*)sums;
  a.ors = (const int32_t*)ors;
  a.out = (int32_t*)out;
  a.desc = (uint4*)desc;
  a.extra = (int32_t*)extra;
  a.n_out = (int32_t*)n_out;
  a.kld = kld;
  a.sld = sld;
  a.old = old;
  a.M = M;
  a.nk = nk;
  a.ns = ns;
  a.no = no;
  a.count = count;
  a.gen = (uint32_t)gen;
  const size_t smem =
      (2 * (size_t)(count + ns + no) + kStage) * sizeof(int32_t);
  seg_kernel<<<tiles, kThreads, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int planes = nk + count + ns + no;
  const int grid = (int)((M + 1023) / 1024 < 1056 ? (M + 1023) / 1024 : 1056);
  seg_fill<<<grid, 256, 0, st>>>((int32_t*)out, planes, nk, M,
                                 (const int32_t*)n_out);
  return (int)cudaGetLastError();
}
