// Build front-end for k <= 63: reads -> canonical kmer key planes + edge
// bytes, one pass.
//
// Replaces: mccortex_tpu/ops/pallas/frontend.py records_fused (kernel
// _make_kernel).  Same contract: (B, L) uint8 base codes (0-3 = ACGT, any
// other value = N/pad) in; NL = 2W int32 key planes (2 for k <= 32, 4 for
// k <= 63: the 32-bit limbs of the key's W 64-bit words), most
// significant first, then one int32 edge-byte plane out.
// Windows that do not fit or hold an N get key -1 in every plane and edge
// 0.  The kernel writes the first lv windows of every row: each plane is
// (B * lv,) row-major, so lv = L gives the (B, L) planes of records_fused
// and lv = L - k + 1 the planes a build epoch sorts, with no copy.
//
// Bound: memory bytes: each window reads 1 byte and writes 4 * (NL + 1)
// bytes.  At the build's 2048 x 150 batches the launch itself is most of
// the time (PERF.md).
//
// Design: one block per tile of whole reads.  The block packs each row of
// its tile into shared memory from one coalesced read of the bytes: the
// forward strand as 2-bit bases in 32-bit words (first base in the top
// bits), the reverse complement of the row the same way, and a 1-bit mask
// of the bases that are not ACGT (5 bits of shared memory a base).  A
// window is then cut out in a fixed number of steps whatever k is: its
// forward key is the 2k-bit field at base i of the forward row (3 words
// and 2 funnel shifts for NL = 2, 5 words and 4 for NL = 4), its reverse
// complement the field at base L - i - k of the reverse-complement row,
// and it is valid iff the mask's k bits at i are 0 (bases past L are
// masked, so a window that runs off the row is invalid).  Neighbouring
// threads own neighbouring windows of the same row, so every plane store
// is coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindowsPerBlock = 1024;
constexpr int kSharedBytes = 48 * 1024;

// 32 bits of a packed row starting at base q >= 0 (base q in the top bits)
__device__ __forceinline__ uint32_t field32(const uint32_t* row, int q) {
  const int w = q >> 4;
  return __funnelshift_l(row[w + 1], row[w], 2 * (q & 15));
}

// reverse the order of the 16 2-bit groups of x
__device__ __forceinline__ uint32_t rev2(uint32_t x) {
  const uint32_t y = __brev(x);
  return ((y >> 1) & 0x55555555u) | ((y & 0x55555555u) << 1);
}

// 64 bits of a packed row starting at base i: (hi, lo), base i on top
__device__ __forceinline__ uint64_t field64(const uint32_t* row, int i) {
  const int w = i >> 4, s = 2 * (i & 15);
  const uint32_t a = row[w], b = row[w + 1], c = row[w + 2];
  return ((uint64_t)__funnelshift_l(b, a, s) << 32) | __funnelshift_l(c, b, s);
}

// the 2k-bit kmer at base i of a packed row, right-aligned in (hi, lo);
// for NL = 2 (k <= 32) hi is 0
template <int NL>
__device__ __forceinline__ void cut(const uint32_t* row, int i, int k,
                                    uint64_t& hi, uint64_t& lo) {
  if (NL == 2) {
    hi = 0;
    lo = field64(row, i) >> (64 - 2 * k);
  } else {
    const uint64_t xh = field64(row, i), xl = field64(row, i + 32);
    const int r = 128 - 2 * k;   // 2..62
    hi = xh >> r;
    lo = (xl >> r) | (xh << (64 - r));
  }
}

// base q of a packed row
__device__ __forceinline__ uint32_t base_at(const uint32_t* row, int q) {
  return (row[q >> 4] >> (30 - 2 * (q & 15))) & 3u;
}

// words of one staged row: forward, reverse complement, then the mask
__host__ __device__ inline int row_words(int nfw) { return 2 * nfw + nfw / 2; }

template <int NL>
__global__ void __launch_bounds__(kThreads)
    frontend_kernel(const uint8_t* __restrict__ bases,
                    int32_t* __restrict__ out, int B, int L, int lv, int k,
                    int rows, int nfw) {
  extern __shared__ uint32_t smem[];
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, B - row0);
  const int stride = row_words(nfw);

  // 1. forward words and mask bits, 16 bases a thread, from the bytes
  for (int t = threadIdx.x; t < nrows * nfw; t += blockDim.x) {
    const int r = t / nfw;
    const int w = t - r * nfw;
    const uint8_t* src = bases + (size_t)(row0 + r) * L;
    uint32_t f = 0, m = 0;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int p = 16 * w + u;
      const uint32_t c = p < L ? (uint32_t)src[p] : 4u;
      f = (f << 2) | (c & 3u);
      m |= (uint32_t)(c > 3u) << u;
    }
    uint32_t* row = smem + r * stride;
    row[w] = f;
    reinterpret_cast<uint16_t*>(row + 2 * nfw)[w] = (uint16_t)m;
  }
  __syncthreads();

  // 2. reverse-complement words: word w holds bases L-1-16w .. L-16-16w of
  // the read, complemented, in that order
  for (int t = threadIdx.x; t < nrows * nfw; t += blockDim.x) {
    const int r = t / nfw;
    const int w = t - r * nfw;
    uint32_t* row = smem + r * stride;
    uint32_t v = 0;
    if (16 * w < L) {
      const int q = L - 16 - 16 * w;     // forward base of the word's end
      const uint32_t f = q >= 0 ? field32(row, q) : row[0] >> (-2 * q);
      v = rev2(~f);
    }
    row[nfw + w] = v;
  }
  __syncthreads();

  // 3. windows
  const int n = nrows * lv;
  const size_t plane = (size_t)B * lv;
  const size_t o0 = (size_t)row0 * lv;
  const uint64_t kmask = (1ull << k) - 1;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int r = t / lv;
    const int i = t - r * lv;
    const uint32_t* fw = smem + r * stride;
    const uint32_t* rc = fw + nfw;
    const uint32_t* mk = fw + 2 * nfw;
    // mask bits i .. i + 63: the window's k bases, then the next base
    const int mw = i >> 5, ms = i & 31;
    const uint64_t bad =
        ((uint64_t)__funnelshift_r(mk[mw + 1], mk[mw + 2], ms) << 32) |
        __funnelshift_r(mk[mw], mk[mw + 1], ms);
    const bool valid = (bad & kmask) == 0;
    uint64_t fh, fl, rh, rl;
    cut<NL>(fw, i, k, fh, fl);
    cut<NL>(rc, max(L - i - k, 0), k, rh, rl);
    // rc < fw strictly picks the reverse complement as the key
    const bool rc_lt = rh < fh || (rh == fh && rl < fl);
    const int orient = rc_lt ? 1 : 0;
    const uint64_t kh = rc_lt ? rh : fh, kl = rc_lt ? rl : fl;
    int32_t ebyte = 0;
    if (valid) {
      // next window valid <=> this one is and base i + k is ACGT (bases
      // past the row are masked)
      if (!((bad >> k) & 1)) {
        ebyte |= 1 << (base_at(fw, i + k) + (orient << 2));
      }
      // previous window valid <=> this one is, i > 0, base i - 1 is ACGT
      if (i > 0 && !((mk[(i - 1) >> 5] >> ((i - 1) & 31)) & 1)) {
        ebyte |= 1 << ((3 - base_at(fw, i - 1)) + ((1 - orient) << 2));
      }
    }
    const size_t o = o0 + t;
    if (NL == 2) {
      out[o] = valid ? (int32_t)(uint32_t)(kl >> 32) : -1;
      out[plane + o] = valid ? (int32_t)(uint32_t)kl : -1;
    } else {
      out[o] = valid ? (int32_t)(uint32_t)(kh >> 32) : -1;
      out[plane + o] = valid ? (int32_t)(uint32_t)kh : -1;
      out[2 * plane + o] = valid ? (int32_t)(uint32_t)(kl >> 32) : -1;
      out[3 * plane + o] = valid ? (int32_t)(uint32_t)kl : -1;
    }
    out[NL * plane + o] = ebyte;
  }
}

}  // namespace

// bases: (B, L) uint8; out: (NL + 1, B * lv) int32, NL = 2 for k <= 32
// else 4; the first lv windows of every row.  Requires 3 <= k <= 63,
// B > 0, 1 <= lv <= L and L <= 65536.
extern "C" int mctx_frontend(const void* bases, void* out, int B, int L,
                             int lv, int k, void* stream) {
  // forward words: the row, then 4 words so that a 5-word cut at the last
  // base stays inside; even, so the mask's 16-bit halves fill whole words
  const int nfw = ((L + 15) / 16 + 4 + 1) & ~1;
  const int row_bytes = row_words(nfw) * (int)sizeof(uint32_t);
  // about kWindowsPerBlock windows a block, in the default 48 KB
  int rows = kWindowsPerBlock / L < kSharedBytes / row_bytes
                 ? kWindowsPerBlock / L
                 : kSharedBytes / row_bytes;
  if (rows < 1) rows = 1;
  const int grid = (B + rows - 1) / rows;
  const size_t smem = (size_t)rows * row_bytes;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* b = (const uint8_t*)bases;
  int32_t* o = (int32_t*)out;
  if (k <= 32) {
    frontend_kernel<2><<<grid, kThreads, smem, st>>>(b, o, B, L, lv, k, rows,
                                                     nfw);
  } else {
    frontend_kernel<4><<<grid, kThreads, smem, st>>>(b, o, B, L, lv, k, rows,
                                                     nfw);
  }
  return (int)cudaGetLastError();
}
