// Batched hash-bucket probe: (Q, W) kmer keys -> (row index, found).
//
// Replaces: mccortex_tpu/ops/pallas/lookup.py lookup_fused (kernel
// _make_kernel), together with the XLA prologue and epilogue of its wrapper:
// the splitmix64 hash, the bucket, the sentinel test and the final masks
// all happen here, so the kernel reads the query words and the table and
// writes idx and found, nothing else.
//
// Table (built on the host, ops/kernels/lookup.py): B = 2^b rows of R
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
