// The linked walker's whole walk in one launch: one warp a walker runs
// every step of links/walk._linked_step until it halts or has taken
// max_steps steps.
//
// Replaces no TPU kernel: the JAX package runs its walk_linked as plain XLA
// under lax.while_loop, and the port ran the same step as ~240 small PyTorch
// operations a step in a host loop (links/walk._walk_plain, which stays as
// the CPU path and the reference).  It covers the walks of the gap filler
// (align/correct.correct_batch): the adjacency given, no hop records, no
// missing-information check, no confidence model, no used-link marks; with
// or without forced priming.
//
// Bound: the latency of a few dependent gathers a step.  A walker's step
// reads the adjacency of its vertex (4 words), the coverage of the
// candidates, its cursors' junction words, then the edge byte and link
// offsets of the vertex it moves to and the seen counts of the links there:
// some 4 reads in a chain, each from a graph that sits in L2.  Walkers are
// independent (nothing they write is read by another), so the card hides
// the latency of one walker behind the others, and a walk costs the chain
// of its longest walker: ~1 us a step against the host loop's ~4 ms.
//
// Design: the walker's state fits a warp.
//   * Lane l holds cursor slots l and l + 32 (CMAX = 64), counter slot l
//     (CMAX2 = 32) and segment l (SMAX = 32).  The scalars (vertex, oriented
//     kmer of W words, Brent fields, status, counts) sit in registers of
//     every lane, computed alike by all, so every branch is warp-uniform.
//   * Lanes 0..3 gather the four candidates' adjacency and coverage; the
//     colour bits and the next vertex come back by ballot and shuffle.
//   * The oldest cohort's vote, its first slot (jnp.argmax of a bool row:
//     the lowest slot) and the split test are ballots; the largest age and
//     the XOR folds of the state hash are shuffle butterflies.
//   * A pickup's s-th link goes to the s-th free slot: each free slot finds
//     its rank among the free slots by popc of the free ballot below it.
//   * The segment push is a __shfl_up_sync.
// The step follows _linked_step in its order (candidates, choice, forced
// priming, cursor step, in-merge test and segments, counter ages, pickup,
// hash and Brent, output and halts), with its integer types, so every field
// of the state comes out equal to the host loop's.  A walker that is not
// active is untouched by a step of the host loop, so the warp leaves the
// walk as soon as its walker halts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // 8 walkers a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPickupCap = 16;         // links examined a node
// GraphStep statuses (graph/traverse.py)
constexpr int POPFWD = 0, COLFWD = 1, POPFRK_COLFWD = 2, NOCOVG = 3,
              NOCOLCOVG = 4, NOLINKS = 5, SPLIT_LINKS = 6, USELINKS = 8,
              HALT_CYCLE = 9, HALT_MAXLEN = 10;

struct Args {
  // graph: union edge byte (N), coverage (N, C) uint32 bits, edge bytes
  // (N, C), adjacency (8N): next vertex or -1
  const uint8_t* uedges;
  const int32_t* covg;
  const uint8_t* edges;
  const int32_t* adj;
  // links: CSR offsets (2N + 1), junctions (L, JW), counts (L), seen (L, LC)
  const int32_t* offsets;
  const uint64_t* seq;
  const int32_t* nj;
  const int32_t* nseen;
  // forced priming: bases (B, F) and counts (B), or null
  const uint8_t* forced;
  const int32_t* forced_n;
  // the state, read and written in place
  int32_t* idx;
  uint8_t* orient;
  uint64_t* okm;        // (B, W)
  uint8_t* active;
  int32_t* status;
  int32_t* nsteps;
  uint64_t* brent_hash;
  int32_t* brent_steps;
  int32_t* brent_limit;
  uint8_t* out_bases;   // (B, Lmax)
  int32_t* out_vert;    // (B, Lmax)
  int32_t* out_len;
  int32_t* cur_link;    // (B, 64)
  int32_t* cur_pos;
  int32_t* cur_age;
  const int32_t* cntr_link;   // (B, 32)
  const int32_t* cntr_pos;
  int32_t* cntr_age;
  int32_t* seg_nodes;   // (B, 32)
  uint8_t* seg_infork;
  int32_t* n_drop;
  int B, k, Lmax, max_steps, colour, C, edge_colour, nlinks, JW, ctpcol, LC,
      F;
};

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// one cursor's share of the state hash: splitmix64(link ^ pos << 24 ^
// age << 48) on the int64 values, 0 for an empty slot
__device__ __forceinline__ uint64_t slot_hash(int32_t link, int32_t pos,
                                              int32_t age) {
  if (link < 0) return 0;
  return splitmix64((uint64_t)(int64_t)link ^ ((uint64_t)(int64_t)pos << 24)
                    ^ ((uint64_t)(int64_t)age << 48));
}

__device__ __forceinline__ int warp_max(int x) {
  for (int d = 16; d > 0; d >>= 1) x = max(x, __shfl_xor_sync(kFull, x, d));
  return x;
}

__device__ __forceinline__ uint64_t warp_xor(uint64_t x) {
  for (int d = 16; d > 0; d >>= 1) x ^= __shfl_xor_sync(kFull, x, d);
  return x;
}

__device__ __forceinline__ int popc4(int nib) { return __popc(nib & 0xF); }

// the base of a one-bit nibble (0 for any other nibble, as _NIB2NUC)
__device__ __forceinline__ int nib2nuc(int nib) {
  return (nib == 2) ? 1 : (nib == 4) ? 2 : (nib == 8) ? 3 : 0;
}

__device__ __forceinline__ int clamp_link(int32_t link, int nlinks) {
  return min(max(link, 0), nlinks - 1);
}

// the junction base at pos of link (lstore.unpack_junc on a clipped link)
__device__ __forceinline__ int junc_base(const Args& a, int32_t link,
                                         int32_t pos) {
  const int64_t lid = clamp_link(link, a.nlinks);
  const int w = min(max(pos >> 5, 0), a.JW - 1);
  const uint64_t word = a.seq[lid * a.JW + w];
  return (int)((word >> (62 - 2 * (pos & 31))) & 3);
}

template <int W>
__global__ void __launch_bounds__(kThreads) walk_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (b >= a.B) return;                 // the whole warp leaves
  const bool links = a.nlinks > 0;

  // the walker's state: scalars in every lane, slots by lane
  int32_t idx = a.idx[b];
  int orient = a.orient[b];
  uint64_t okm[W];
#pragma unroll
  for (int w = 0; w < W; ++w) okm[w] = a.okm[(int64_t)b * W + w];
  bool active = a.active[b] != 0;
  int32_t status = a.status[b];
  int32_t nsteps = a.nsteps[b];
  uint64_t bh = a.brent_hash[b];
  int32_t bsteps = a.brent_steps[b];
  int32_t blimit = a.brent_limit[b];
  int32_t out_len = a.out_len[b];
  int32_t n_drop = a.n_drop[b];
  const int64_t s64 = (int64_t)b * 64, s32 = (int64_t)b * 32;
  int32_t link_lo = a.cur_link[s64 + lane];
  int32_t link_hi = a.cur_link[s64 + 32 + lane];
  int32_t pos_lo = a.cur_pos[s64 + lane];
  int32_t pos_hi = a.cur_pos[s64 + 32 + lane];
  int32_t age_lo = a.cur_age[s64 + lane];
  int32_t age_hi = a.cur_age[s64 + 32 + lane];
  const int32_t clink = a.cntr_link[s32 + lane];
  const int32_t cpos = a.cntr_pos[s32 + lane];
  int32_t cage = a.cntr_age[s32 + lane];
  int32_t seg_nodes = a.seg_nodes[s32 + lane];
  bool seg_infork = a.seg_infork[s32 + lane] != 0;
  const int forced_n = a.forced != nullptr ? a.forced_n[b] : 0;

  const int top_bits = 2 * a.k - 64 * (W - 1);
  const uint64_t top_mask = top_bits < 64 ? (1ull << top_bits) - 1 : ~0ull;
  const int first_off = 2 * (a.k - 1);

  for (int it = 0; active && it < a.max_steps; ++it) {
    // candidates: the population nibble and, through the adjacency, the
    // next vertices (lane n holds base n's) and their coverage
    const int64_t v = 2 * (int64_t)idx + orient;
    const int pop_nib = (a.uedges[idx] >> (orient * 4)) & 0xF;
    int32_t nv_l = -1;
    bool incol = false;
    if (lane < 4) {
      nv_l = a.adj[4 * v + lane];
      incol = nv_l >= 0 &&
              (a.colour < 0 ||
               a.covg[(int64_t)(nv_l >> 1) * a.C + a.colour] != 0);
    }
    const int col_nib = pop_nib & (int)(__ballot_sync(kFull, incol) & 0xF);

    // the linkless decision (choose_linkless: the first true condition)
    const int npop = popc4(pop_nib), ncol = popc4(col_nib);
    int status0 = NOLINKS;
    if (npop == 0) status0 = NOCOVG;
    else if (npop == 1 && ncol == 1) status0 = COLFWD;
    else if (npop == 1 && ncol == 0) status0 = POPFWD;
    else if (npop > 1 && ncol == 1) status0 = POPFRK_COLFWD;
    else if (npop > 1 && ncol == 0) status0 = NOCOLCOVG;
    int nuc = nib2nuc(status0 == POPFWD ? pop_nib : col_nib);
    bool go = status0 == COLFWD || status0 == POPFRK_COLFWD ||
              status0 == POPFWD;
    int32_t st = status0;

    // the cursors' current junction bases (live slots only: no other
    // slot's base reaches an output)
    const bool live_lo = link_lo >= 0, live_hi = link_hi >= 0;
    int base_lo = 0, base_hi = 0;
    if (links) {
      if (live_lo) base_lo = junc_base(a, link_lo, pos_lo);
      if (live_hi) base_hi = junc_base(a, link_hi, pos_hi);
      // _choose_linked without the missing-information check
      const bool fork = status0 == NOLINKS;
      const int max_age = warp_max(max(live_lo ? age_lo : -1,
                                       live_hi ? age_hi : -1));
      const bool has_curs = __any_sync(kFull, live_lo || live_hi);
      const bool old_lo = live_lo && age_lo == max_age;
      const bool old_hi = live_hi && age_hi == max_age;
      const unsigned ob_lo = __ballot_sync(kFull, old_lo);
      const unsigned ob_hi = __ballot_sync(kFull, old_hi);
      const int first = ob_lo ? __ffs(ob_lo) - 1
                              : (ob_hi ? 32 + __ffs(ob_hi) - 1 : 0);
      const int rep = __shfl_sync(kFull, first < 32 ? base_lo : base_hi,
                                  first & 31);
      const bool split = __any_sync(kFull, (old_lo && base_lo != rep) ||
                                               (old_hi && base_hi != rep));
      const bool cand_ok = ((col_nib >> rep) & 1) != 0;
      const bool no_curs = !has_curs || max_age < 1;
      const bool use = fork && !no_curs && !split && cand_ok;
      if (fork) {
        st = no_curs ? NOLINKS
                     : (split || !cand_ok ? SPLIT_LINKS : USELINKS);
        go = use;
      }
      if (use) nuc = rep;
    }
    bool is_fork = st == USELINKS;

    // forced priming: the first forced_n steps take the given bases
    if (it < forced_n) {
      nuc = a.forced[(int64_t)b * a.F + min(max(it, 0), a.F - 1)];
      go = true;
      is_fork = ncol > 1;
    }

    // the move
    const bool adv = go;
    const int lost_nuc =
        (int)((okm[W - 1 - first_off / 64] >> (first_off % 64)) & 3);
    if (adv) {
      const int32_t nv = max(__shfl_sync(kFull, nv_l, nuc), 0);
#pragma unroll
      for (int w = 0; w < W - 1; ++w) {
        okm[w] = (okm[w] << 2) | (okm[w + 1] >> 62);
      }
      okm[W - 1] = (okm[W - 1] << 2) | (uint64_t)nuc;
      okm[0] &= top_mask;
      idx = nv >> 1;
      orient = nv & 1;
    }

    // cursors on a resolved fork: a live cursor whose base differs from
    // the taken one, or that is exhausted, dies; the others consume a base
    const bool mf = adv && is_fork;
    if (links) {
      if (mf && live_lo) {
        const int32_t nj = a.nj[clamp_link(link_lo, a.nlinks)];
        if (base_lo == nuc && pos_lo + 1 < nj) ++pos_lo;
        else link_lo = -1;
      }
      if (mf && live_hi) {
        const int32_t nj = a.nj[clamp_link(link_hi, a.nlinks)];
        if (base_hi == nuc && pos_hi + 1 < nj) ++pos_hi;
        else link_hi = -1;
      }
      if (!live_lo) link_lo = -1;
      if (!live_hi) link_hi = -1;
    }

    // segment boundary: the fork taken, or an in-merge at the new node
    bool rv_fork = false;
    if (adv) {
      const int e = a.edges[(int64_t)idx * a.C + a.edge_colour];
      const int in_nib = (e >> ((1 - orient) * 4)) & 0xF;
      const int back_bit = 1 << ((3 - lost_nuc) & 3);
      rv_fork = (in_nib & ~back_bit) > 0;
    }
    const bool bump = mf || rv_fork;
    if (bump) {
      if (links) {
        if (link_lo >= 0) ++age_lo;
        if (link_hi >= 0) ++age_hi;
      }
      const int32_t up_nodes = __shfl_up_sync(kFull, seg_nodes, 1);
      const bool up_fork = __shfl_up_sync(kFull, (int)seg_infork, 1) != 0;
      seg_nodes = lane == 0 ? 0 : up_nodes;
      seg_infork = lane == 0 ? rv_fork : up_fork;
    }
    if (lane == 0 && adv) ++seg_nodes;
    if (links && bump && clink >= 0) ++cage;

    // pickup at the new vertex: link s (s < 16, seen in the colour) takes
    // the s-th free slot if there is one; the rest are counted dropped
    if (links && adv) {
      const int64_t v2 = 2 * (int64_t)idx + orient;
      const int32_t start = a.offsets[v2];
      const int32_t navail = a.offsets[v2 + 1] - start;
      bool ok = false;
      if (lane < kPickupCap && lane < navail) {
        const int lid = clamp_link(start + lane, a.nlinks);
        ok = a.nseen[(int64_t)lid * a.LC + a.ctpcol] != 0;
      }
      unsigned okm_bits = __ballot_sync(kFull, ok);
      const unsigned free_lo = __ballot_sync(kFull, link_lo < 0);
      const unsigned free_hi = __ballot_sync(kFull, link_hi < 0);
      const int nfree = __popc(free_lo) + __popc(free_hi);
      const unsigned has = nfree >= kPickupCap ? 0xFFFFu : (1u << nfree) - 1;
      n_drop += max(navail - kPickupCap, 0) + __popc(okm_bits & ~has);
      okm_bits &= has;
      const unsigned below = (1u << lane) - 1;
      const int rank_lo = __popc(free_lo & below);
      const int rank_hi = __popc(free_lo) + __popc(free_hi & below);
      if (link_lo < 0 && rank_lo < kPickupCap && ((okm_bits >> rank_lo) & 1)) {
        link_lo = clamp_link(start + rank_lo, a.nlinks);
        pos_lo = 0;
        age_lo = 0;
      }
      if (link_hi < 0 && rank_hi < kPickupCap && ((okm_bits >> rank_hi) & 1)) {
        link_hi = clamp_link(start + rank_hi, a.nlinks);
        pos_hi = 0;
        age_hi = 0;
      }
    }

    // Brent cycle check on the hash of (kmer, cursors, counter cursors)
    uint64_t h = splitmix64(okm[0]);
#pragma unroll
    for (int w = 1; w < W; ++w) h = splitmix64(h ^ okm[w]);
    if (links) {
      h ^= warp_xor(slot_hash(link_lo, pos_lo, age_lo)
                    ^ slot_hash(link_hi, pos_hi, age_hi)
                    ^ slot_hash(clink, cpos, cage));
    }
    const bool cyc = adv && h == bh;
    const bool take_cp = adv && bsteps + 1 >= blimit;
    if (take_cp) {
      bh = h;
      bsteps = 0;
      blimit *= 2;
    } else if (adv) {
      ++bsteps;
    }

    // the output base, and the halts
    const bool adv2 = adv && !cyc;
    const bool hit_max = adv2 && out_len >= a.Lmax;
    if (adv2 && !hit_max) {
      if (lane == 0) {
        const int64_t o = (int64_t)b * a.Lmax + out_len;
        a.out_bases[o] = (uint8_t)nuc;
        a.out_vert[o] = idx * 2 + orient;
      }
      ++out_len;
    }
    status = adv ? (cyc ? HALT_CYCLE : (hit_max ? HALT_MAXLEN : st)) : st;
    active = go && !cyc && !hit_max;
    ++nsteps;
  }

  if (lane == 0) {
    a.idx[b] = idx;
    a.orient[b] = (uint8_t)orient;
#pragma unroll
    for (int w = 0; w < W; ++w) a.okm[(int64_t)b * W + w] = okm[w];
    a.active[b] = active ? 1 : 0;
    a.status[b] = status;
    a.nsteps[b] = nsteps;
    a.brent_hash[b] = bh;
    a.brent_steps[b] = bsteps;
    a.brent_limit[b] = blimit;
    a.out_len[b] = out_len;
    a.n_drop[b] = n_drop;
  }
  a.cur_link[s64 + lane] = link_lo;
  a.cur_link[s64 + 32 + lane] = link_hi;
  a.cur_pos[s64 + lane] = pos_lo;
  a.cur_pos[s64 + 32 + lane] = pos_hi;
  a.cur_age[s64 + lane] = age_lo;
  a.cur_age[s64 + 32 + lane] = age_hi;
  a.cntr_age[s32 + lane] = cage;
  a.seg_nodes[s32 + lane] = seg_nodes;
  a.seg_infork[s32 + lane] = seg_infork ? 1 : 0;
}

template <int W>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int warps = kThreads / 32;
  const int blocks = (a.B + warps - 1) / warps;
  walk_kernel<W><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// p: the 31 pointers of Args in its order (forced and forced_n may be null);
// every array contiguous.  W = 1..4 words a kmer; B > 0; nlinks = 0 leaves
// every cursor, counter age and pickup as it is (links/walk's no-links
// step); colour < 0 tests no coverage.
extern "C" int mctx_walk(
    const void* uedges, const void* covg, const void* edges, const void* adj,
    const void* offsets, const void* seq, const void* nj, const void* nseen,
    const void* forced, const void* forced_n, void* idx, void* orient,
    void* okm, void* active, void* status, void* nsteps, void* brent_hash,
    void* brent_steps, void* brent_limit, void* out_bases, void* out_vert,
    void* out_len, void* cur_link, void* cur_pos, void* cur_age,
    const void* cntr_link, const void* cntr_pos, void* cntr_age,
    void* seg_nodes, void* seg_infork, void* n_drop, int B, int W, int k,
    int Lmax, int max_steps, int colour, int C, int edge_colour, int nlinks,
    int JW, int ctpcol, int LC, int F, void* stream) {
  if (B <= 0 || (forced != nullptr && F <= 0)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{(const uint8_t*)uedges, (const int32_t*)covg, (const uint8_t*)edges,
         (const int32_t*)adj, (const int32_t*)offsets, (const uint64_t*)seq,
         (const int32_t*)nj, (const int32_t*)nseen, (const uint8_t*)forced,
         (const int32_t*)forced_n, (int32_t*)idx, (uint8_t*)orient,
         (uint64_t*)okm, (uint8_t*)active, (int32_t*)status, (int32_t*)nsteps,
         (uint64_t*)brent_hash, (int32_t*)brent_steps, (int32_t*)brent_limit,
         (uint8_t*)out_bases, (int32_t*)out_vert, (int32_t*)out_len,
         (int32_t*)cur_link, (int32_t*)cur_pos, (int32_t*)cur_age,
         (const int32_t*)cntr_link, (const int32_t*)cntr_pos,
         (int32_t*)cntr_age, (int32_t*)seg_nodes, (uint8_t*)seg_infork,
         (int32_t*)n_drop, B, k, Lmax, max_steps, colour, C, edge_colour,
         nlinks, JW, ctpcol, LC, F};
  cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 1: return (int)launch<1>(a, st);
    case 2: return (int)launch<2>(a, st);
    case 3: return (int)launch<3>(a, st);
    case 4: return (int)launch<4>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
