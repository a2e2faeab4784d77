// Batched hash-bucket probe: (Q, W) kmer keys -> (row index, found).
//
// Replaces: mccortex_tpu/ops/pallas/lookup.py lookup_fused (kernel
// _make_kernel), together with the XLA prologue and epilogue of its wrapper:
// the splitmix64 hash, the bucket, the sentinel test and the final masks
// all happen here, so the kernel reads the query words and the table and
// writes idx and found, nothing else.
//
// Table (ops/kernels/lookup.py; the 128-byte-row table of CUDA keys built by
// mctx_table32 below, that of CPU keys in numpy): B = 2^b rows of R
// uint32, R = 32 (build_table32: one 128-byte line of device memory, the
// table the port uses) or R = 128 (build_table128: the reference's 128-lane
// row).  A row holds S = R / (2W+1) slots, plane-major
// [w0_hi x S | w0_lo x S | ... | row_idx x S | pad]; slots fill from the
// front; empty and pad words are 0xFFFFFFFF.  home(key) = splitmix64 fold of
// the words >> (64 - b).  A key sits in its home row or, when rows are full,
// some rows further on (modulo B) with only full rows in between, so a probe
// walks from the home row and ends at a hit or at the first row whose last
// slot is empty (or after B rows).
//
// Bound: device memory bytes, and the latency of one dependent random read.
// Each query costs its 8W-byte read, one row read that depends on it and a
// 5-byte write; the row is nearly the whole byte bill, so the row is one
// 128-byte line and no more (the 128-lane row of the TPU's vector drags 512
// bytes per query to use some 176 of them at W = 1).  After the bytes comes
// the instruction issue: at one line a query the card can finish 26 G
// queries a second, so a query may cost only a few warp instructions.
//
// Design: the TPU kernel pipelines 128 row DMAs per wave into VMEM and
// compares a (128, 128) block with lane rolls.  Here a warp owns 32
// consecutive queries and a 4 KB stage in shared memory.  Lane l reads query
// l (one coalesced read a warp), tests the sentinel and hashes it once.
//   * Fetch.  A group of R/4 lanes (8 for the 128-byte row: four rows per
//     instruction; the whole warp for the 128-lane row) copies one query's
//     row, 16 bytes a lane, one coalesced line, straight from device memory
//     into the stage with cp.async (no registers in between; L2 only).  The
//     bucket comes by shuffle from the lane that owns the query.  All rows
//     of a pass (32 rows of 128 bytes, or 8 of 512) are in flight together.
//     The 16-byte chunks of a row are stored at chunk ^ (row & 7), so that
//     lanes reading the same chunk of different rows hit different banks.
//   * Compare.  For the 128-byte row each lane then takes its own query's
//     row out of the stage with eight 16-byte reads and compares all S slots
//     from registers, every index known at compile time: no ballot, no
//     shuffle, and one instruction serves 32 queries.  (Comparing with the
//     group of 8 lanes that fetched the row, the plane bits joined by
//     ballots, would cost some 900 warp instructions per 32 queries against
//     some 200 here: as much time as the row reads.)  For the 128-lane row
//     four lanes share a query (8 queries a pass, 4 passes), each scanning
//     every fourth slot out of the stage, joined by two shuffles.
//   * Chain.  The rare query whose row was full without a hit reads the next
//     row from device memory directly, in a loop the whole warp stays in.
//   * Results go back to the owning lanes (by shuffle for the 128-lane row)
//     and leave as one coalesced write of idx and one of found per warp.
// Every warp intrinsic runs with the full mask: lanes past Q and sentinel
// queries stay in the warp as idle queries that fetch no row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageWords = 1024;     // uint32 of stage per warp: 4 KB
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kEmpty = 0xffffffffu;

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// 16 bytes from device memory to shared memory, asynchronously
__device__ __forceinline__ void copy16_async(uint4* dst, const uint4* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}

// this thread's asynchronous copies have landed
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.commit_group;" ::);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// word j of a row held in registers as 16-byte chunks
template <int CH>
struct RegRow {
  uint4 c[CH];
  __device__ __forceinline__ uint32_t operator()(int j) const {
    return word_of(c[j >> 2], j & 3);
  }
};

// word j of row q of the stage (chunks stored at chunk ^ (q & 7))
struct StageRow {
  const uint32_t* row;
  int swz;
  __device__ __forceinline__ uint32_t operator()(int j) const {
    return row[(((j >> 2) ^ swz) << 2) | (j & 3)];
  }
};

// word j of a row in device memory
struct GlobalRow {
  const uint32_t* row;
  __device__ __forceinline__ uint32_t operator()(int j) const {
    return __ldg(row + j);
  }
};

// The slots s0, s0 + step, ... of one row against the query limbs.  Keys
// are unique, so at most one slot holds the key.
template <int W, int S, int STEP, class Row>
__device__ __forceinline__ void scan(const Row& row,
                                     const uint32_t (&limb)[2 * W], int s0,
                                     bool& found, uint32_t& idx) {
#pragma unroll
  for (int t0 = 0; t0 < S; t0 += STEP) {
    const int t = t0 + s0;
    if (t < S) {
      bool eq = true;
#pragma unroll
      for (int p = 0; p < 2 * W; ++p) eq = eq && row(p * S + t) == limb[p];
      if (eq) {
        found = true;
        idx = row(2 * W * S + t);
      }
    }
  }
}

template <int W, int R>
__global__ void __launch_bounds__(kThreads)
    lookup_kernel(const uint64_t* __restrict__ queries, long long Q,
                  const uint32_t* __restrict__ table, int b_bits,
                  int32_t* __restrict__ idx_out,
                  uint8_t* __restrict__ found_out) {
  constexpr int S = R / (2 * W + 1);    // slots a row
  constexpr int CH = R / 4;             // 16-byte chunks a row
  constexpr int QP = kStageWords / R;   // queries a pass: 32 or 8
  constexpr int LPQ = 32 / QP;          // lanes that compare one query
  constexpr int PASSES = 32 / QP;
  constexpr int COPIES = QP * CH / 32;  // chunks a lane copies per pass
  __shared__ uint4 stages[kThreads / 32][kStageWords / 4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first =
      ((long long)blockIdx.x * (kThreads / 32) + warp) * 32;
  if (first >= Q) return;               // the same for the whole warp
  uint4* stage = stages[warp];
  const uint4* table4 = reinterpret_cast<const uint4*>(table);
  const long long qi = first + lane;
  const uint32_t row_mask = (1u << b_bits) - 1u;

  // this lane's own query
  uint64_t w[W];
  bool live = false;                    // past Q and sentinels: never found
#pragma unroll
  for (int i = 0; i < W; ++i) {
    w[i] = qi < Q ? queries[qi * W + i] : ~0ull;
    live |= w[i] != ~0ull;
  }
  uint64_t h = splitmix64(w[0]);        // seed 0
#pragma unroll
  for (int i = 1; i < W; ++i) h = splitmix64(h ^ w[i]);
  const int home = live ? (int)(h >> (64 - b_bits)) : -1;
  uint32_t my_idx = 0;
  bool my_found = false;

#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    // fetch the home rows of the pass's live queries into the stage
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {
      const int id = i * 32 + lane;
      const int q = id / CH, c = id % CH;
      const int src = __shfl_sync(kFull, home, pass * QP + q);
      if (src >= 0) {
        copy16_async(stage + q * CH + (c ^ (q & 7)),
                     table4 + (size_t)src * CH + c);
      }
    }
    copy_wait();
    __syncwarp();

    // this lane's query of the pass, and the slots it scans
    const int q = lane / LPQ, s0 = lane % LPQ;
    const int owner = pass * QP + q;
    int bkt = home;
    uint32_t limb[2 * W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      uint64_t x = w[i];
      if (LPQ > 1) x = __shfl_sync(kFull, x, owner);
      limb[2 * i] = (uint32_t)(x >> 32);
      limb[2 * i + 1] = (uint32_t)x;
    }
    if (LPQ > 1) bkt = __shfl_sync(kFull, bkt, owner);
    const bool probing = bkt >= 0;

    bool found = false, full;
    uint32_t idx = 0;
    if constexpr (LPQ == 1) {
      RegRow<CH> row;
#pragma unroll
      for (int k = 0; k < CH; ++k) row.c[k] = stage[q * CH + (k ^ (q & 7))];
      scan<W, S, LPQ>(row, limb, s0, found, idx);
      full = row(S - 1) != kEmpty;
    } else {
      const StageRow row{reinterpret_cast<const uint32_t*>(stage + q * CH),
                         q & 7};
      scan<W, S, LPQ>(row, limb, s0, found, idx);
      full = row(S - 1) != kEmpty;
    }

    // a full row without the key: the next row, at most B rows in all
    uint32_t steps = 1;
    while (true) {
      if (LPQ > 1) {
#pragma unroll
        for (int d = 1; d < LPQ; d <<= 1) {
          const bool of = __shfl_xor_sync(kFull, (int)found, d) != 0;
          const uint32_t oi = __shfl_xor_sync(kFull, idx, d);
          if (of) {
            found = true;
            idx = oi;
          }
        }
      }
      const bool more = probing && !found && full && steps <= row_mask;
      if (!__any_sync(kFull, more)) break;
      if (more) {
        bkt = (int)(((uint32_t)bkt + 1u) & row_mask);
        ++steps;
        const GlobalRow row{table + (size_t)bkt * R};
        scan<W, S, LPQ>(row, limb, s0, found, idx);
        full = row(S - 1) != kEmpty;
      }
    }
    found = found && probing;

    // back to the lane that owns the query
    const int from = (lane % QP) * LPQ;
    const uint32_t ridx = __shfl_sync(kFull, idx, from);
    const bool rfound = __shfl_sync(kFull, (int)found, from) != 0;
    if (lane / QP == pass) {
      my_idx = ridx;
      my_found = rfound;
    }
    __syncwarp();                       // the stage is free for the next pass
  }
  if (qi < Q) {
    idx_out[qi] = my_found ? (int32_t)my_idx : 0;
    found_out[qi] = my_found ? 1 : 0;
  }
}

template <int W, int R>
cudaError_t launch(const void* queries, const void* table, void* idx,
                   void* found, int Q, int b_bits, cudaStream_t st) {
  // one query a thread
  const int blocks = (int)(((long long)Q + kThreads - 1) / kThreads);
  lookup_kernel<W, R><<<blocks, kThreads, 0, st>>>(
      (const uint64_t*)queries, Q, (const uint32_t*)table, b_bits,
      (int32_t*)idx, (uint8_t*)found);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_w(const void* queries, const void* table, void* idx,
                     void* found, int Q, int W, int b_bits, cudaStream_t st) {
  switch (W) {
    case 1: return launch<1, R>(queries, table, idx, found, Q, b_bits, st);
    case 2: return launch<2, R>(queries, table, idx, found, Q, b_bits, st);
    case 3: return launch<3, R>(queries, table, idx, found, Q, b_bits, st);
    case 4: return launch<4, R>(queries, table, idx, found, Q, b_bits, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// queries: (Q, W) uint64, contiguous.  table: (2^b_bits, row_words) uint32,
// contiguous, 16-byte aligned, row_words 32 or 128.  idx: Q int32.  found: Q
// bytes (0/1).  1 <= W <= 4, 1 <= b_bits <= 31, Q > 0.
extern "C" int mctx_lookup(const void* queries, const void* table, void* idx,
                           void* found, int Q, int W, int b_bits,
                           int row_words, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b_bits < 1 || b_bits > 31) return (int)cudaErrorInvalidValue;
  switch (row_words) {
    case 32:
      return (int)launch_w<32>(queries, table, idx, found, Q, W, b_bits, st);
    case 128:
      return (int)launch_w<128>(queries, table, idx, found, Q, W, b_bits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The 128-byte-row table built on the card: ops/kernels/lookup.build_table32,
// byte for byte.
//
// Replaces no TPU kernel: the JAX package builds its table on the host in
// numpy, and so did the port (build_table32, which stays as the CPU path and
// the oracle), after copying every live key to the host and before copying
// the table back.
//
// Rule (build_table32's): a key's home row is splitmix64-fold(key) >>
// (64 - b).  A row takes its own keys in store-row order from slot 0; the
// keys it cannot take move to the next row (modulo B) and are placed there
// in the next round, after what that row holds, in store-row order; rounds
// repeat until no key is left.  In round t a row receives keys from one row
// only, the row before it, and those come sorted: so a round is a list of
// segments (row, sorted store rows), one a row at most, and what a row cannot
// take is the tail of its segment, which goes on to the next row as it is.
//
// Bound: device memory bytes.  The table is written once (B x 128 bytes,
// empty words included) and the keys read once (8W bytes a key); at the
// E. coli graph's 16.4M raw kmers that is 537 + 131 MB, 0.2 ms at 3.35 TB/s.
// The counting sort below adds about 24 bytes a key of scratch traffic and
// one random 8W-byte read of each key's words when its row is written.
//
// Design, bandwidth first, no atomics deciding a slot:
//   * count: a thread a key hashes it, writes its home row and takes a rank
//     in the row's histogram (an atomic add, whose order does not matter).
//   * offsets: an exclusive scan of the histogram (tile sums, one block
//     scanning them, each tile's own scan).
//   * scatter: each key's store row into its row's bucket at offset + rank.
//   * place: a warp writes 32 consecutive rows; lane l sorts its row's store
//     rows in registers (a 16-wide sorting network; a row with more keys,
//     which hashing makes rare, sorts its bucket in place), takes the first S,
//     gathers their words and builds the whole row, empty words included, in
//     a 4 KB stage (word j of row q at ((j + q) & 31): no bank conflicts);
//     the warp then writes each row as one 128-byte line.  No separate fill
//     of empty words goes over the table.  The sorted tail of a row with more
//     than S keys becomes a segment of the next round (row + 1, its bucket
//     tail), appended to a list by one atomic add a warp.
//   * chain (the later rounds, one launch each): a thread a segment reads
//     its row's fill from the row-index plane (slots fill from the front, and
//     no store row is 0xFFFFFFFF), writes the keys that fit after it and
//     passes the rest on.  The host reads the list's length, one word, after
//     each round and stops at 0.  Round 1 leaves ~0.1 % of the keys at W = 1
//     and ~1.6 % at W = 2, so the later rounds are small.
// ---------------------------------------------------------------------------

namespace {

constexpr int kScanItems = 16;                     // histogram words a thread
constexpr int kScanTile = kThreads * kScanItems;   // 4096 rows a block
constexpr int kSortCap = 16;                       // a row sorted in registers

// exclusive prefix of v over the block's threads, in thread order; total is
// the block's sum.  sums holds kThreads / 32 words of shared memory.
__device__ __forceinline__ uint32_t block_exclusive(uint32_t v, uint32_t* sums,
                                                    uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  uint32_t before = 0;
  total = 0;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) {
    const uint32_t s = sums[k];
    if (k < warp) before += s;
    total += s;
  }
  __syncthreads();                      // sums is free for the next call
  return before + x - v;
}

// a segment (row, start in the bucket array, length) for each lane that has
// one, appended to desc by one atomic add a warp; the whole warp calls it
__device__ __forceinline__ void append_segment(bool want, uint32_t row,
                                               uint32_t start, uint32_t len,
                                               uint32_t* desc,
                                               uint32_t* ndesc) {
  const unsigned m = __ballot_sync(kFull, want);
  if (m == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  uint32_t base = 0;
  if (lane == leader) base = atomicAdd(ndesc, (uint32_t)__popc(m));
  base = __shfl_sync(kFull, base, leader);
  if (want) {
    const uint32_t at = base + (uint32_t)__popc(m & ((1u << lane) - 1u));
    desc[3 * (size_t)at] = row;
    desc[3 * (size_t)at + 1] = start;
    desc[3 * (size_t)at + 2] = len;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    t32_count(const uint64_t* __restrict__ keys, int n, int b_bits,
              uint32_t* __restrict__ cnt, uint32_t* __restrict__ home,
              uint32_t* __restrict__ rank) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint64_t* key = keys + (size_t)i * W;
  uint64_t h = splitmix64(key[0]);      // seed 0, as the lookup
#pragma unroll
  for (int w = 1; w < W; ++w) h = splitmix64(h ^ key[w]);
  const uint32_t r = (uint32_t)(h >> (64 - b_bits));
  home[i] = r;
  rank[i] = atomicAdd(cnt + r, 1u);
}

__global__ void __launch_bounds__(kThreads)
    t32_tile_sums(const uint32_t* __restrict__ cnt, uint32_t B,
                  uint32_t* __restrict__ part) {
  __shared__ uint32_t sums[kThreads / 32];
  const size_t tile = (size_t)blockIdx.x * kScanTile;
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const size_t r = tile + (size_t)j * kThreads + threadIdx.x;
    if (r < B) s += cnt[r];
  }
  uint32_t total;
  block_exclusive(s, sums, total);
  if (threadIdx.x == 0) part[blockIdx.x] = total;
}

// the tile sums scanned in place by one block
__global__ void __launch_bounds__(kThreads)
    t32_scan_tiles(uint32_t* __restrict__ part, int tiles) {
  __shared__ uint32_t sums[kThreads / 32];
  uint32_t carry = 0;
  for (int base = 0; base < tiles; base += kThreads) {
    const int i = base + threadIdx.x;
    const uint32_t v = i < tiles ? part[i] : 0u;
    uint32_t total;
    const uint32_t ex = block_exclusive(v, sums, total);
    if (i < tiles) part[i] = carry + ex;
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads)
    t32_offsets(const uint32_t* __restrict__ cnt, uint32_t B,
                const uint32_t* __restrict__ part, uint32_t* __restrict__ off) {
  __shared__ uint32_t sums[kThreads / 32];
  const size_t first = (size_t)blockIdx.x * kScanTile +
                       (size_t)threadIdx.x * kScanItems;
  uint32_t c[kScanItems];
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    c[j] = first + j < B ? cnt[first + j] : 0u;
    s += c[j];
  }
  uint32_t total;
  uint32_t run = part[blockIdx.x] + block_exclusive(s, sums, total);
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    if (first + j < B) off[first + j] = run;
    run += c[j];
  }
}

__global__ void __launch_bounds__(kThreads)
    t32_scatter(const uint32_t* __restrict__ home,
                const uint32_t* __restrict__ rank, int n,
                const uint32_t* __restrict__ off,
                uint32_t* __restrict__ bucket) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) bucket[off[home[i]] + rank[i]] = (uint32_t)i;
}

// ascending bitonic network over N (a power of two) registers
template <int N>
__device__ __forceinline__ void sort_regs(uint32_t (&v)[N]) {
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const uint32_t lo = min(v[i], v[l]), hi = max(v[i], v[l]);
          const bool up = (i & k) == 0;
          v[i] = up ? lo : hi;
          v[l] = up ? hi : lo;
        }
      }
    }
  }
}

// round 1: every row written whole, its own keys in store-row order
template <int W>
__global__ void __launch_bounds__(kThreads)
    t32_place(const uint64_t* __restrict__ keys,
              const uint32_t* __restrict__ cnt,
              const uint32_t* __restrict__ off, uint32_t* __restrict__ bucket,
              int b_bits, uint32_t* __restrict__ table,
              uint32_t* __restrict__ desc, uint32_t* __restrict__ ndesc) {
  constexpr int S = 32 / (2 * W + 1);
  __shared__ uint32_t stages[kThreads / 32][32 * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t B = 1u << b_bits;
  const uint32_t r0 = ((uint32_t)blockIdx.x * (kThreads / 32) + warp) * 32u;
  if (r0 >= B) return;                  // the same for the whole warp
  const uint32_t r = r0 + lane;
  const bool mine = r < B;
  const uint32_t c = mine ? cnt[r] : 0u;
  const uint32_t o = mine ? off[r] : 0u;
  uint32_t* seg = bucket + o;

  uint32_t v[kSortCap];
  const bool fast = c <= (uint32_t)kSortCap;
  if (fast) {
#pragma unroll
    for (int j = 0; j < kSortCap; ++j) v[j] = (uint32_t)j < c ? seg[j] : kEmpty;
    sort_regs(v);
  } else {                              // rare: sort the bucket in place
    for (uint32_t a = 1; a < c; ++a) {
      const uint32_t x = seg[a];
      uint32_t b = a;
      for (; b > 0 && seg[b - 1] > x; --b) seg[b] = seg[b - 1];
      seg[b] = x;
    }
  }

  uint32_t* stage = stages[warp];
  uint32_t* row = stage + lane * 32;
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const bool placed = (uint32_t)t < c;
    const uint32_t id = placed ? (fast ? v[t] : seg[t]) : kEmpty;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint64_t x = placed ? keys[(size_t)id * W + i] : ~0ull;
      row[((2 * i) * S + t + lane) & 31] = (uint32_t)(x >> 32);
      row[((2 * i + 1) * S + t + lane) & 31] = (uint32_t)x;
    }
    row[(2 * W * S + t + lane) & 31] = id;
  }
#pragma unroll
  for (int j = (2 * W + 1) * S; j < 32; ++j) row[(j + lane) & 31] = kEmpty;

  // what the row cannot take goes on to the next row, sorted
  const bool over = c > (uint32_t)S;
  if (over && fast) {
#pragma unroll
    for (int t = S; t < kSortCap; ++t) {
      if ((uint32_t)t < c) seg[t] = v[t];
    }
  }
  append_segment(over, (r + 1u) & (B - 1u), o + S, c - S, desc, ndesc);
  __syncwarp();

  // the warp's rows out, one 128-byte line an instruction
#pragma unroll 4
  for (int q = 0; q < 32; ++q) {
    if (r0 + q < B) {
      table[(size_t)(r0 + q) * 32 + lane] = stage[q * 32 + ((lane + q) & 31)];
    }
  }
}

// a later round: a thread a segment
template <int W>
__global__ void __launch_bounds__(kThreads)
    t32_chain(const uint64_t* __restrict__ keys,
              const uint32_t* __restrict__ bucket,
              const uint32_t* __restrict__ desc_in, int m, int b_bits,
              uint32_t* __restrict__ table, uint32_t* __restrict__ desc_out,
              uint32_t* __restrict__ ndesc_out) {
  constexpr int S = 32 / (2 * W + 1);
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d - (int)(threadIdx.x & 31) >= m) return;  // the same for the warp
  const bool mine = d < m;
  uint32_t row = 0, start = 0, len = 0;
  if (mine) {
    row = desc_in[3 * (size_t)d];
    start = desc_in[3 * (size_t)d + 1];
    len = desc_in[3 * (size_t)d + 2];
  }
  uint32_t* line = table + (size_t)row * 32;
  uint32_t fill = 0;
  if (mine) {
#pragma unroll
    for (int t = 0; t < S; ++t) fill += line[2 * W * S + t] != kEmpty;
  }
  const uint32_t take = min(len, (uint32_t)S - fill);
  for (uint32_t j = 0; j < take; ++j) {
    const uint32_t id = bucket[start + j];
    const uint32_t t = fill + j;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint64_t x = keys[(size_t)id * W + i];
      line[(2 * i) * S + t] = (uint32_t)(x >> 32);
      line[(2 * i + 1) * S + t] = (uint32_t)x;
    }
    line[2 * W * S + t] = id;
  }
  const uint32_t B = 1u << b_bits;
  append_segment(len > take, (row + 1u) & (B - 1u), start + take, len - take,
                 desc_out, ndesc_out);
}

template <int W>
cudaError_t table32_first(const void* keys, void* table, void* cnt, void* off,
                          void* part, void* home, void* rank, void* bucket,
                          void* desc, void* ndesc, int n, int b_bits,
                          cudaStream_t st) {
  const uint32_t B = 1u << b_bits;
  const int tiles = (int)((B + kScanTile - 1) / kScanTile);
  const int key_blocks = (n + kThreads - 1) / kThreads;
  cudaError_t e = cudaMemsetAsync(cnt, 0, (size_t)B * 4, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(ndesc, 0, 4, st);
  if (e != cudaSuccess) return e;
  if (n > 0) {
    t32_count<W><<<key_blocks, kThreads, 0, st>>>(
        (const uint64_t*)keys, n, b_bits, (uint32_t*)cnt, (uint32_t*)home,
        (uint32_t*)rank);
  }
  t32_tile_sums<<<tiles, kThreads, 0, st>>>((const uint32_t*)cnt, B,
                                            (uint32_t*)part);
  t32_scan_tiles<<<1, kThreads, 0, st>>>((uint32_t*)part, tiles);
  t32_offsets<<<tiles, kThreads, 0, st>>>((const uint32_t*)cnt, B,
                                          (const uint32_t*)part,
                                          (uint32_t*)off);
  if (n > 0) {
    t32_scatter<<<key_blocks, kThreads, 0, st>>>(
        (const uint32_t*)home, (const uint32_t*)rank, n, (const uint32_t*)off,
        (uint32_t*)bucket);
  }
  const int row_blocks = (int)((B + kThreads - 1) / kThreads);
  t32_place<W><<<row_blocks, kThreads, 0, st>>>(
      (const uint64_t*)keys, (const uint32_t*)cnt, (const uint32_t*)off,
      (uint32_t*)bucket, b_bits, (uint32_t*)table, (uint32_t*)desc,
      (uint32_t*)ndesc);
  return cudaGetLastError();
}

template <int W>
cudaError_t table32_round(const void* keys, void* table, const void* bucket,
                          const void* desc_in, void* desc_out,
                          void* ndesc_out, int m, int b_bits,
                          cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(ndesc_out, 0, 4, st);
  if (e != cudaSuccess) return e;
  t32_chain<W><<<(m + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const uint64_t*)keys, (const uint32_t*)bucket,
      (const uint32_t*)desc_in, m, b_bits, (uint32_t*)table,
      (uint32_t*)desc_out, (uint32_t*)ndesc_out);
  return cudaGetLastError();
}

}  // namespace

// Round 1 of the table of the live keys (n, W) uint64, contiguous.  table:
// (2^b_bits, 32) uint32, every word written.  Scratch, uint32: cnt and off
// 2^b_bits each, part ceil(2^b_bits / 4096), home, rank and bucket n each,
// desc 3 x (n / (S + 1) + 1), ndesc 1 (the number of segments left for round
// 2).  1 <= W <= 4, 1 <= b_bits <= 30, 0 <= n <= S x 2^b_bits.
extern "C" int mctx_table32(const void* keys, void* table, void* cnt,
                            void* off, void* part, void* home, void* rank,
                            void* bucket, void* desc, void* ndesc, int n,
                            int W, int b_bits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b_bits < 1 || b_bits > 30 || n < 0) return (int)cudaErrorInvalidValue;
  switch (W) {
    case 1: return (int)table32_first<1>(keys, table, cnt, off, part, home,
                                         rank, bucket, desc, ndesc, n, b_bits,
                                         st);
    case 2: return (int)table32_first<2>(keys, table, cnt, off, part, home,
                                         rank, bucket, desc, ndesc, n, b_bits,
                                         st);
    case 3: return (int)table32_first<3>(keys, table, cnt, off, part, home,
                                         rank, bucket, desc, ndesc, n, b_bits,
                                         st);
    case 4: return (int)table32_first<4>(keys, table, cnt, off, part, home,
                                         rank, bucket, desc, ndesc, n, b_bits,
                                         st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// A later round: the m > 0 segments of desc_in placed after their rows' fill,
// what is left written to desc_out (room for m) and counted in ndesc_out.
extern "C" int mctx_table32_round(const void* keys, void* table,
                                  const void* bucket, const void* desc_in,
                                  void* desc_out, void* ndesc_out, int m,
                                  int W, int b_bits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b_bits < 1 || b_bits > 30 || m < 1) return (int)cudaErrorInvalidValue;
  switch (W) {
    case 1: return (int)table32_round<1>(keys, table, bucket, desc_in,
                                         desc_out, ndesc_out, m, b_bits, st);
    case 2: return (int)table32_round<2>(keys, table, bucket, desc_in,
                                         desc_out, ndesc_out, m, b_bits, st);
    case 3: return (int)table32_round<3>(keys, table, bucket, desc_in,
                                         desc_out, ndesc_out, m, b_bits, st);
    case 4: return (int)table32_round<4>(keys, table, bucket, desc_in,
                                         desc_out, ndesc_out, m, b_bits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
