// Row gather: out[i] = table[ids[i]], bitwise.
//
// Replaces tpu_sage/kernels/gather.py::gather_rows (manual row DMAs, with
// its jit wrapper gather_rows_pallas and the bf16 entry gather_rows_bf16 /
// bitcast_table_i32, which exist only because Mosaic cannot slice single
// rows of a packed bf16 buffer). Here the kernel is generic over the element
// type: it moves bytes. The wrapper's plan (kernels/gather.py::gather_plan,
// a pure function of the row's byte width and both base addresses mod 16)
// picks one of two forms:
//
// * words (rows whose width and both bases are 16-byte multiples, up to
//   2,048 bytes; and rows of at most 128 bytes, or of odd width): the widest
//   word of 16, 4, 2 or 1 bytes that divides the row and both bases; a
//   power-of-two group of lanes per row (so a 4-byte row, the (n, 1) degree
//   view, puts 32 rows in a warp, and a 512-byte int32 adjacency row of
//   16-byte words one row in a warp, one word per lane). A lane issues all
//   its loads of the row (WPL of them, a template argument: the words per
//   lane, at most 4; wider rows go in chunks) before its first store, so a
//   1,024-byte f32 row has both of a lane's 16-byte loads in flight at once.
// * realign (rows wider than 128 bytes whose width and bases are multiples
//   of 2): the main path's rows. A 602-wide bf16 feature row is 1,204 bytes
//   and so only 4-byte aligned, and the source offset (4·id mod 16) and the
//   destination offset (4·r mod 16) differ from row to row; a 602-byte int8
//   row is only 2-byte aligned. A group of LPR lanes owns a row: LPR is the
//   smallest power of two, at least 8, that covers the row's span of aligned
//   16-byte words (at most 32), so a 200-byte row takes 16 lanes and two
//   rows share a warp. Each lane loads the aligned 16-byte words that cover
//   the source span (lane l of the group takes words l, l + LPR, ...), all
//   WPL of them (a template argument, so the loads are unrolled and all
//   issued before the first store), then realigns them to the destination by
//   taking 4-byte components from its own word and its neighbour's
//   (__shfl_down_sync within the group), shifted by 2 bytes with a funnel
//   shift when the offsets differ by 2 mod 4 (UNIT = 2: the alignment the
//   row and both bases share), and stores aligned 16-byte words in the row's
//   interior and 4- or 2-byte pieces at its head and tail. Rows wider than
//   LPR·WPL words go in chunks of that many. A 16-byte word that reaches
//   outside the table's bytes (possible only at the first and last rows,
//   when the table's ends are not 16-byte aligned) is read component by
//   component: each aligned 4-byte component that holds a table byte (it
//   lies inside the table's allocation, whose granules are 4-byte aligned),
//   the others read as 0.
//
// In both forms the ids of a warp's rows are loaded once, coalesced, and
// shared by shuffle; table words are read through the non-coherent path.
//
// Bound on the H100: bytes. The minimum traffic is the ids, the gathered
// rows read once and written once: 15.4 MB each way for the 12,800-row bf16
// feature gather (0.0087 ms at 3.35 TB/s), 0.6 MB each way at 512 rows. The
// realign form issues a group's whole row, 76 16-byte words at 1,204 bytes,
// before its first store. Measured on the H100 (PERF.md), it moves rows at
// about 2.6 TB/s of reads and writes together once the first loads return;
// what stands above the bound is the launch and the two dependent loads (the
// id, then the row) before any row moves: 0.006 ms alone at 512 rows.
//
// Out-of-range ids follow the reference's two forms (tpu_sage/ops.py):
// oob_zero = 0 ("plain") wraps a negative id once by n, as Python indexing
// does, then clamps to [0, n); oob_zero = 1 ("masked") writes a zero row.

#include <cuda_runtime.h>
#include <cstdint>

static constexpr unsigned kFull = 0xffffffffu;
static constexpr int kWarps = 8;  // warps per block in both forms

// The row an id names, or -1 for a zero row.
__device__ __forceinline__ int64_t resolve_id(int64_t id, int64_t n_table, int oob_zero) {
  if (id < 0 || id >= n_table) {
    if (oob_zero) return -1;
    if (id < 0) id += n_table;
    id = id < 0 ? 0 : (id >= n_table ? n_table - 1 : id);
  }
  return id;
}

// ---- the words form --------------------------------------------------------

template <typename W, int WPL>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows_words_kernel(const W* __restrict__ table, const int32_t* __restrict__ ids,
                         W* __restrict__ out, int64_t n_table, int64_t q, int64_t row_words,
                         int lanes_per_row, int oob_zero) {
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 32 / lanes_per_row;
  const int64_t row0 = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * rows_per_warp;
  const int mine = (lane < rows_per_warp && row0 + lane < q) ? __ldg(ids + row0 + lane) : 0;
  const int r = lane / lanes_per_row;
  const int64_t id = resolve_id(__shfl_sync(kFull, mine, r), n_table, oob_zero);
  const int64_t row = row0 + r;
  if (row >= q) return;
  W* dst = out + row * row_words;
  const W* src = table + (id < 0 ? 0 : id) * row_words;
  const int sub = lane - r * lanes_per_row;
  for (int64_t base = sub; base < row_words; base += (int64_t)lanes_per_row * WPL) {
    W v[WPL];
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      const int64_t j = base + (int64_t)lanes_per_row * i;
      v[i] = (id >= 0 && j < row_words) ? __ldg(src + j) : W{};
    }
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      const int64_t j = base + (int64_t)lanes_per_row * i;
      if (j < row_words) dst[j] = v[i];
    }
  }
}

// ---- the realign form ------------------------------------------------------

// The aligned 16-byte word at byte address a; the aligned 4-byte components
// that hold no byte of [lo, hi) (the table's bytes) are never read and come
// back 0.
__device__ __forceinline__ uint4 load_word(uintptr_t a, uintptr_t lo, uintptr_t hi) {
  if (a >= lo && a + 16 <= hi) return __ldg(reinterpret_cast<const uint4*>(a));
  uint32_t c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uintptr_t ai = a + 4 * i;
    c[i] = (ai + 4 > lo && ai < hi) ? __ldg(reinterpret_cast<const uint32_t*>(ai)) : 0u;
  }
  return make_uint4(c[0], c[1], c[2], c[3]);
}

// Bytes sh .. sh + 15 (sh a multiple of UNIT in [0, 16)) of the 32 in (a, b).
template <int UNIT>
__device__ __forceinline__ uint4 funnel(uint4 a, uint4 b, int sh) {
  uint32_t c0, c1, c2, c3, c4;
  switch (sh >> 2) {
    case 0: c0 = a.x; c1 = a.y; c2 = a.z; c3 = a.w; c4 = b.x; break;
    case 1: c0 = a.y; c1 = a.z; c2 = a.w; c3 = b.x; c4 = b.y; break;
    case 2: c0 = a.z; c1 = a.w; c2 = b.x; c3 = b.y; c4 = b.z; break;
    default: c0 = a.w; c1 = b.x; c2 = b.y; c3 = b.z; c4 = b.w; break;
  }
  if (UNIT == 2 && (sh & 2))
    return make_uint4(__funnelshift_r(c0, c1, 16), __funnelshift_r(c1, c2, 16),
                      __funnelshift_r(c2, c3, 16), __funnelshift_r(c3, c4, 16));
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint4 shfl_down_word(uint4 v, int delta, int width) {
  return make_uint4(__shfl_down_sync(kFull, v.x, delta, width),
                    __shfl_down_sync(kFull, v.y, delta, width),
                    __shfl_down_sync(kFull, v.z, delta, width),
                    __shfl_down_sync(kFull, v.w, delta, width));
}

__device__ __forceinline__ uint4 shfl_word(uint4 v, int src, int width) {
  return make_uint4(__shfl_sync(kFull, v.x, src, width), __shfl_sync(kFull, v.y, src, width),
                    __shfl_sync(kFull, v.z, src, width), __shfl_sync(kFull, v.w, src, width));
}

// Store the aligned 16-byte word w at byte address a, only its bytes inside
// [lo, hi) (the destination row; both ends multiples of UNIT).
template <int UNIT>
__device__ __forceinline__ void store_word(uintptr_t a, uint4 w, uintptr_t lo, uintptr_t hi) {
  if (a >= lo && a + 16 <= hi) {
    *reinterpret_cast<uint4*>(a) = w;
    return;
  }
  const uint32_t c[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uintptr_t ai = a + 4 * i;
    if (ai >= lo && ai + 4 <= hi) {
      *reinterpret_cast<uint32_t*>(ai) = c[i];
    } else if (UNIT == 2) {
      if (ai >= lo && ai < hi) *reinterpret_cast<uint16_t*>(ai) = (uint16_t)c[i];
      if (ai + 2 >= lo && ai + 2 < hi) *reinterpret_cast<uint16_t*>(ai + 2) = (uint16_t)(c[i] >> 16);
    }
  }
}

template <int WPL, int LPR, int UNIT>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows_realign_kernel(const uint8_t* __restrict__ table, const int32_t* __restrict__ ids,
                           uint8_t* __restrict__ out, int64_t n_table, int64_t q,
                           int64_t row_bytes, int oob_zero) {
  constexpr int kRows = 32 / LPR;  // rows per warp
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPR, r = lane / LPR;
  const int64_t row0 = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  const int mine = (lane < kRows && row0 + lane < q) ? __ldg(ids + row0 + lane) : 0;
  const int64_t row = row0 + r;
  const bool live = row < q;  // every lane stays for the shuffles below
  const int64_t id = resolve_id(__shfl_sync(kFull, mine, r), n_table, oob_zero);

  const uintptr_t tlo = reinterpret_cast<uintptr_t>(table);
  const uintptr_t thi = tlo + (uintptr_t)(n_table * row_bytes);
  const uintptr_t s = tlo + (uintptr_t)((id < 0 ? 0 : id) * row_bytes);
  const uintptr_t d = reinterpret_cast<uintptr_t>(out) + (uintptr_t)((live ? row : 0) * row_bytes);
  const uintptr_t s0 = s & ~(uintptr_t)15, d0 = d & ~(uintptr_t)15;
  // destination word j (at d0 + 16 j) holds source bytes sh .. sh + 15 of
  // words j + f and j + f + 1 of the source span (at s0 + 16 k)
  const int delta = (int)(s - s0) - (int)(d - d0);  // -14 .. 14, a multiple of UNIT
  const int f = delta < 0 ? -1 : 0;
  const int sh = delta - 16 * f;
  const int64_t n_src = ((int64_t)(s - s0) + row_bytes + 15) >> 4;
  const int64_t n_dst = ((int64_t)(d - d0) + row_bytes + 15) >> 4;
  const bool load = live && id >= 0;
  // the same trip count for every row of the warp: the most words a row can span
  const int64_t span = (16 - UNIT + row_bytes + 15) >> 4;

  for (int64_t base = 0; base < span; base += LPR * WPL) {
    uint4 v[WPL + 1];
#pragma unroll
    for (int i = 0; i <= WPL; ++i) {
      // word WPL of the chunk only feeds the group's last lane's last store:
      // the group's first lane loads it
      const int64_t k = base + sub + LPR * i + f;
      v[i] = (load && k >= 0 && k < n_src && (i < WPL || sub == 0))
                 ? load_word(s0 + 16 * k, tlo, thi)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      uint4 next = shfl_down_word(v[i], 1, LPR);
      const uint4 wrap = shfl_word(v[i + 1], 0, LPR);
      if (sub == LPR - 1) next = wrap;
      const int64_t j = base + sub + LPR * i;
      if (live && j < n_dst) store_word<UNIT>(d0 + 16 * j, funnel<UNIT>(v[i], next, sh), d,
                                             d + row_bytes);
    }
  }
}

// ---- entry point -----------------------------------------------------------

template <typename W>
static void launch_words(const void* table, const void* ids, void* out, int64_t n_table,
                         int64_t q, int64_t row_words, int lanes_per_row, int oob_zero,
                         cudaStream_t stream) {
  const int64_t rows_per_block = (int64_t)kWarps * (32 / lanes_per_row);
  const unsigned blocks = (unsigned)((q + rows_per_block - 1) / rows_per_block);
  const int64_t wpl = (row_words + lanes_per_row - 1) / lanes_per_row;
#define TSG_WORDS(N)                                                                      \
  gather_rows_words_kernel<W, N><<<blocks, kWarps * 32, 0, stream>>>(                     \
      (const W*)table, (const int32_t*)ids, (W*)out, n_table, q, row_words, lanes_per_row, \
      oob_zero)
  if (wpl <= 1) TSG_WORDS(1);
  else if (wpl == 2) TSG_WORDS(2);
  else if (wpl == 3) TSG_WORDS(3);
  else TSG_WORDS(4);
#undef TSG_WORDS
}

template <int WPL, int LPR, int UNIT>
static void launch_realign(const void* table, const void* ids, void* out, int64_t n_table,
                           int64_t q, int64_t row_bytes, int oob_zero, cudaStream_t stream) {
  const int64_t rows_per_block = (int64_t)kWarps * (32 / LPR);
  const unsigned blocks = (unsigned)((q + rows_per_block - 1) / rows_per_block);
  gather_rows_realign_kernel<WPL, LPR, UNIT><<<blocks, kWarps * 32, 0, stream>>>(
      (const uint8_t*)table, (const int32_t*)ids, (uint8_t*)out, n_table, q, row_bytes,
      oob_zero);
}

template <int LPR, int UNIT>
static int launch_realign_wpl(const void* table, const void* ids, void* out, int64_t n_table,
                              int64_t q, int64_t row_bytes, int words_per_lane, int oob_zero,
                              cudaStream_t s) {
  switch (words_per_lane) {
    case 1: launch_realign<1, LPR, UNIT>(table, ids, out, n_table, q, row_bytes, oob_zero, s); break;
    case 2: launch_realign<2, LPR, UNIT>(table, ids, out, n_table, q, row_bytes, oob_zero, s); break;
    case 3: launch_realign<3, LPR, UNIT>(table, ids, out, n_table, q, row_bytes, oob_zero, s); break;
    case 4: launch_realign<4, LPR, UNIT>(table, ids, out, n_table, q, row_bytes, oob_zero, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int UNIT>
static int launch_realign_lpr(const void* table, const void* ids, void* out, int64_t n_table,
                              int64_t q, int64_t row_bytes, int lanes_per_row,
                              int words_per_lane, int oob_zero, cudaStream_t s) {
  switch (lanes_per_row) {
    case 8: return launch_realign_wpl<8, UNIT>(table, ids, out, n_table, q, row_bytes,
                                               words_per_lane, oob_zero, s);
    case 16: return launch_realign_wpl<16, UNIT>(table, ids, out, n_table, q, row_bytes,
                                                 words_per_lane, oob_zero, s);
    case 32: return launch_realign_wpl<32, UNIT>(table, ids, out, n_table, q, row_bytes,
                                                 words_per_lane, oob_zero, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// words_per_lane in 1..4 takes the realign form (row and both bases
// multiples of 2 bytes, realigned in 4-byte pieces when all three are
// multiples of 4; lanes_per_row 8, 16 or 32; word_bytes unused); 0 takes the
// words form with word_bytes in {16, 4, 2, 1} dividing the row and both
// bases and lanes_per_row a power of two up to 32 (each lane's words per
// chunk follow from the row's words).
extern "C" int tsg_gather_rows(const void* table, const void* ids, void* out,
                               long long n_table, long long q, long long row_bytes,
                               int word_bytes, int lanes_per_row, int words_per_lane,
                               int oob_zero, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (words_per_lane > 0) {
    const uintptr_t bits = (uintptr_t)row_bytes | (uintptr_t)table | (uintptr_t)out;
    if (bits % 2) return (int)cudaErrorInvalidValue;
    return bits % 4 ? launch_realign_lpr<2>(table, ids, out, n_table, q, row_bytes,
                                            lanes_per_row, words_per_lane, oob_zero, s)
                    : launch_realign_lpr<4>(table, ids, out, n_table, q, row_bytes,
                                            lanes_per_row, words_per_lane, oob_zero, s);
  }
  if (lanes_per_row < 1 || lanes_per_row > 32 || (lanes_per_row & (lanes_per_row - 1)))
    return (int)cudaErrorInvalidValue;
  const int64_t words = row_bytes / word_bytes;
  switch (word_bytes) {
    case 16: launch_words<uint4>(table, ids, out, n_table, q, words, lanes_per_row, oob_zero, s); break;
    case 4: launch_words<uint32_t>(table, ids, out, n_table, q, words, lanes_per_row, oob_zero, s); break;
    case 2: launch_words<uint16_t>(table, ids, out, n_table, q, words, lanes_per_row, oob_zero, s); break;
    case 1: launch_words<uint8_t>(table, ids, out, n_table, q, words, lanes_per_row, oob_zero, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Row gather, one row per block: the measurement foil.
//
// Replaces tpu_sage/kernels/gather.py::gather_rows_blockspec, the index-map
// formulation that copies one row per grid step (its issue rate bounded by
// grid-step overhead), which the JAX package keeps only as a baseline for
// gather_rows. Its counterpart here is the same naive shape: one block of
// 128 threads per output row, walking the row in the widest word of 16, 4,
// 2 or 1 bytes that divides the row and both bases. Bound on the H100:
// bytes, as for gather_rows; the design keeps one row per block on purpose,
// so a block's launch and retirement, not the bytes, set its rate, as the
// grid step does on the TPU. Out-of-range ids clamp as gather_rows's
// "clamp" form does (a negative id wraps once by n, then clamps to [0, n)),
// so no id reads outside the table.

template <typename W>
__global__ void gather_rows_blockspec_kernel(const W* __restrict__ table,
                                             const int32_t* __restrict__ ids,
                                             W* __restrict__ out, int64_t n_table,
                                             int64_t row_words) {
  const int64_t row = blockIdx.x;
  int64_t id = ids[row];
  if (id < 0) id += n_table;
  id = id < 0 ? 0 : (id >= n_table ? n_table - 1 : id);
  const W* src = table + id * row_words;
  W* dst = out + row * row_words;
  for (int64_t j = threadIdx.x; j < row_words; j += blockDim.x) dst[j] = src[j];
}

template <typename W>
static void launch_blockspec(const void* table, const void* ids, void* out, int64_t n_table,
                             int64_t q, int64_t row_words, cudaStream_t stream) {
  gather_rows_blockspec_kernel<W><<<(unsigned)q, 128, 0, stream>>>(
      (const W*)table, (const int32_t*)ids, (W*)out, n_table, row_words);
}

extern "C" int tsg_gather_rows_blockspec(const void* table, const void* ids, void* out,
                                         long long n_table, long long q, long long row_bytes,
                                         int word_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t words = row_bytes / word_bytes;
  switch (word_bytes) {
    case 16: launch_blockspec<uint4>(table, ids, out, n_table, q, words, s); break;
    case 4: launch_blockspec<uint32_t>(table, ids, out, n_table, q, words, s); break;
    case 2: launch_blockspec<uint16_t>(table, ids, out, n_table, q, words, s); break;
    case 1: launch_blockspec<uint8_t>(table, ids, out, n_table, q, words, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
