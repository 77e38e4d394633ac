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
// In id order (ORDERED, a template flag of both forms): where a table is
// larger than L2 and each row is asked for several times (the exact pass's
// chunks: 524,288 ids over 232,965 rows, each distinct row about 2.5 times),
// rows walked in output order leave HBM once per id, because the repeats of
// a row lie far apart. tsg_gather_order (below) first lists the positions
// bucket by bucket of ids (id >> shift), and the gather then walks that
// list: slot r of the walk gathers id ids_in_order[r] into output row
// order[r], so the repeats of a row come together and all but the first
// are served from L2. Each output row is still written once, with the same
// bytes: the output is bitwise the one of the walk in output order.
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

// In id order, a row's neighbours in the output are written at other
// times, so a 32-byte sector that a row shares with a neighbour would reach
// L2 in two halves far apart, and each half-written sector go back to HBM
// as a read, merge and write when L2 evicts it. So the row's first lane
// reads its first sector and its last lane its last one (where they are
// shared) through L2 before the row's stores: the stores then land in a
// whole sector, which goes back as a plain write.
__device__ __forceinline__ void seam_fill(uintptr_t d, uintptr_t e, int sub, int lanes) {
  if (sub == 0 && (d & 31)) asm volatile("prefetch.global.L2 [%0];" ::"l"(d & ~(uintptr_t)31));
  if (sub == lanes - 1 && (e & 31))
    asm volatile("prefetch.global.L2 [%0];" ::"l"(e & ~(uintptr_t)31));
}

// ---- the words form --------------------------------------------------------

// ORDERED: slot row of the walk writes output row order[row] (ids are then
// the ids in that order); otherwise slot row writes row row.
template <typename W, int WPL, bool ORDERED>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows_words_kernel(const W* __restrict__ table, const int32_t* __restrict__ ids,
                         const int32_t* __restrict__ order, W* __restrict__ out, int64_t n_table,
                         int64_t q, int64_t row_words, int lanes_per_row, int oob_zero) {
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 32 / lanes_per_row;
  const int64_t row0 = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * rows_per_warp;
  const bool has = lane < rows_per_warp && row0 + lane < q;
  const int mine = has ? __ldg(ids + row0 + lane) : 0;
  const int mine_slot = ORDERED && has ? __ldg(order + row0 + lane) : 0;
  const int r = lane / lanes_per_row;
  const int64_t id = resolve_id(__shfl_sync(kFull, mine, r), n_table, oob_zero);
  const int64_t row = row0 + r;
  const int64_t slot = ORDERED ? (int64_t)__shfl_sync(kFull, mine_slot, r) : row;
  if (row >= q) return;
  W* dst = out + slot * row_words;
  const W* src = table + (id < 0 ? 0 : id) * row_words;
  const int sub = lane - r * lanes_per_row;
  if (ORDERED)
    seam_fill(reinterpret_cast<uintptr_t>(dst), reinterpret_cast<uintptr_t>(dst + row_words), sub,
              lanes_per_row);
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

template <int WPL, int LPR, int UNIT, bool ORDERED>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows_realign_kernel(const uint8_t* __restrict__ table, const int32_t* __restrict__ ids,
                           const int32_t* __restrict__ order, uint8_t* __restrict__ out,
                           int64_t n_table, int64_t q, int64_t row_bytes, int oob_zero) {
  constexpr int kRows = 32 / LPR;  // rows per warp
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPR, r = lane / LPR;
  const int64_t row0 = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  const bool has = lane < kRows && row0 + lane < q;
  const int mine = has ? __ldg(ids + row0 + lane) : 0;
  const int mine_slot = ORDERED && has ? __ldg(order + row0 + lane) : 0;
  const int64_t row = row0 + r;
  const bool live = row < q;  // every lane stays for the shuffles below
  const int64_t id = resolve_id(__shfl_sync(kFull, mine, r), n_table, oob_zero);
  const int64_t slot = ORDERED ? (int64_t)__shfl_sync(kFull, mine_slot, r) : row;

  const uintptr_t tlo = reinterpret_cast<uintptr_t>(table);
  const uintptr_t thi = tlo + (uintptr_t)(n_table * row_bytes);
  const uintptr_t s = tlo + (uintptr_t)((id < 0 ? 0 : id) * row_bytes);
  const uintptr_t d = reinterpret_cast<uintptr_t>(out) + (uintptr_t)((live ? slot : 0) * row_bytes);
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
  if (ORDERED && live) seam_fill(d, d + row_bytes, sub, LPR);

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

// The launch of one form: a struct, so that the bool ORDERED can follow a
// runtime pointer (order null: output order) through one dispatch.
struct Rows {
  const void* table;
  const void* ids;
  const int32_t* order;
  void* out;
  int64_t n_table, q;
  int oob_zero;
  cudaStream_t stream;
};

template <typename W, int WPL, bool ORDERED>
static void launch_words_as(const Rows& a, int64_t row_words, int lanes_per_row) {
  const int64_t rows_per_block = (int64_t)kWarps * (32 / lanes_per_row);
  const unsigned blocks = (unsigned)((a.q + rows_per_block - 1) / rows_per_block);
  gather_rows_words_kernel<W, WPL, ORDERED><<<blocks, kWarps * 32, 0, a.stream>>>(
      (const W*)a.table, (const int32_t*)a.ids, a.order, (W*)a.out, a.n_table, a.q, row_words,
      lanes_per_row, a.oob_zero);
}

template <typename W, int WPL>
static void launch_words_wpl(const Rows& a, int64_t row_words, int lanes_per_row) {
  if (a.order) launch_words_as<W, WPL, true>(a, row_words, lanes_per_row);
  else launch_words_as<W, WPL, false>(a, row_words, lanes_per_row);
}

template <typename W>
static void launch_words(const Rows& a, int64_t row_words, int lanes_per_row) {
  const int64_t wpl = (row_words + lanes_per_row - 1) / lanes_per_row;
  if (wpl <= 1) launch_words_wpl<W, 1>(a, row_words, lanes_per_row);
  else if (wpl == 2) launch_words_wpl<W, 2>(a, row_words, lanes_per_row);
  else if (wpl == 3) launch_words_wpl<W, 3>(a, row_words, lanes_per_row);
  else launch_words_wpl<W, 4>(a, row_words, lanes_per_row);
}

template <int WPL, int LPR, int UNIT>
static void launch_realign(const Rows& a, int64_t row_bytes) {
  const int64_t rows_per_block = (int64_t)kWarps * (32 / LPR);
  const unsigned blocks = (unsigned)((a.q + rows_per_block - 1) / rows_per_block);
#define TSG_REALIGN(ORD)                                                                 \
  gather_rows_realign_kernel<WPL, LPR, UNIT, ORD><<<blocks, kWarps * 32, 0, a.stream>>>( \
      (const uint8_t*)a.table, (const int32_t*)a.ids, a.order, (uint8_t*)a.out, a.n_table,  \
      a.q, row_bytes, a.oob_zero)
  if (a.order) TSG_REALIGN(true);
  else TSG_REALIGN(false);
#undef TSG_REALIGN
}

template <int LPR, int UNIT>
static int launch_realign_wpl(const Rows& a, int64_t row_bytes, int words_per_lane) {
  switch (words_per_lane) {
    case 1: launch_realign<1, LPR, UNIT>(a, row_bytes); break;
    case 2: launch_realign<2, LPR, UNIT>(a, row_bytes); break;
    case 3: launch_realign<3, LPR, UNIT>(a, row_bytes); break;
    case 4: launch_realign<4, LPR, UNIT>(a, row_bytes); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int UNIT>
static int launch_realign_lpr(const Rows& a, int64_t row_bytes, int lanes_per_row,
                              int words_per_lane) {
  switch (lanes_per_row) {
    case 8: return launch_realign_wpl<8, UNIT>(a, row_bytes, words_per_lane);
    case 16: return launch_realign_wpl<16, UNIT>(a, row_bytes, words_per_lane);
    case 32: return launch_realign_wpl<32, UNIT>(a, row_bytes, words_per_lane);
    default: return (int)cudaErrorInvalidValue;
  }
}

// words_per_lane in 1..4 takes the realign form (row and both bases
// multiples of 2 bytes, realigned in 4-byte pieces when all three are
// multiples of 4; lanes_per_row 8, 16 or 32; word_bytes unused); 0 takes the
// words form with word_bytes in {16, 4, 2, 1} dividing the row and both
// bases and lanes_per_row a power of two up to 32 (each lane's words per
// chunk follow from the row's words). order null walks the rows in output
// order; else slot r gathers ids[r] into output row order[r] (order and ids
// from tsg_gather_order).
extern "C" int tsg_gather_rows(const void* table, const void* ids, const void* order, void* out,
                               long long n_table, long long q, long long row_bytes,
                               int word_bytes, int lanes_per_row, int words_per_lane,
                               int oob_zero, void* stream) {
  const Rows a{table, ids, (const int32_t*)order, out, n_table, q, oob_zero,
               (cudaStream_t)stream};
  if (words_per_lane > 0) {
    const uintptr_t bits = (uintptr_t)row_bytes | (uintptr_t)table | (uintptr_t)out;
    if (bits % 2) return (int)cudaErrorInvalidValue;
    return bits % 4 ? launch_realign_lpr<2>(a, row_bytes, lanes_per_row, words_per_lane)
                    : launch_realign_lpr<4>(a, row_bytes, lanes_per_row, words_per_lane);
  }
  if (lanes_per_row < 1 || lanes_per_row > 32 || (lanes_per_row & (lanes_per_row - 1)))
    return (int)cudaErrorInvalidValue;
  const int64_t words = row_bytes / word_bytes;
  switch (word_bytes) {
    case 16: launch_words<uint4>(a, words, lanes_per_row); break;
    case 4: launch_words<uint32_t>(a, words, lanes_per_row); break;
    case 2: launch_words<uint16_t>(a, words, lanes_per_row); break;
    case 1: launch_words<uint8_t>(a, words, lanes_per_row); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---- the ordering: positions bucket by bucket of ids ------------------------
//
// A stable counting sort of the positions 0 .. q - 1 by bucket: id >> shift
// for an id in [0, n_table), and one bucket after those (n_buckets - 1) for
// -1 and every other out-of-range id. It writes order (q,), the positions
// bucket by bucket and in position order within a bucket, and ids_in_order
// (q,) = ids[order], so the gather loads both coalesced. No JAX counterpart:
// the JAX package gathers in output order. Plain version:
// kernels/gather.py::gather_order_reference. The wrapper's plan
// (gather_order_plan) picks shift so that n_buckets <= kOrderMaxBuckets.
//
// Three launches, each over tiles of kOrderTile positions (a warp takes 256
// consecutive positions, 8 steps of 32):
// 1. gather_order_count_kernel: each tile's count per bucket, a histogram in
//    shared memory, to counts[tile][bucket];
// 2. gather_order_offsets_kernel: per bucket, the exclusive scan of its
//    counts over the tiles (in place) and its total; a lane a bucket, the
//    tiles split over the block's warps;
// 3. gather_order_scatter_kernel: each warp's count per bucket (same_key
//    groups a step's lanes by bucket, the lowest lane adds the group); one
//    block scan of the totals (each bucket's first slot) and of the tile's
//    counts (each bucket's first slot in the tile); the tile's positions
//    bucket by bucket into shared memory (warps, steps and lanes follow
//    the positions, so a bucket keeps position order), then out in that
//    order, so a bucket's run of the tile lands on consecutive slots.
//
// Bound on the H100: bytes and launches. The ids are read twice and order
// and ids_in_order written once (8 MB at the exact pass's 524,288 ids,
// 0.0025 ms at 3.35 TB/s); the counts (tiles x buckets, 0.5 MB there) stay
// in L2. What it buys: at the exact pass's chunks the gather's reads fall
// from every id's row to about each distinct row once.

static constexpr int kOrderMaxBuckets = 512;  // the out-of-range bucket included
static constexpr int kOrderSteps = 8;          // steps of 32 positions a warp
static constexpr int kOrderTile = kWarps * 32 * kOrderSteps;  // positions a block: 2,048

__device__ __forceinline__ int order_key(int id, int64_t n_table, int shift, int oob_bucket) {
  return (id >= 0 && id < n_table) ? (id >> shift) : oob_bucket;
}

// The lanes whose key equals this lane's, keys in [0, 2^kOrderKeyBits): one
// ballot a bit (match.any costs about a pass a distinct key, and a warp's
// 32 buckets are mostly distinct).
static constexpr int kOrderKeyBits = 10;  // buckets and the past-the-end key kOrderMaxBuckets
__device__ __forceinline__ unsigned same_key(int key) {
  unsigned same = kFull;
#pragma unroll
  for (int i = 0; i < kOrderKeyBits; ++i) {
    const bool bit = (key >> i) & 1;
    const unsigned set = __ballot_sync(kFull, bit);
    same &= bit ? set : ~set;
  }
  return same;
}

__global__ void __launch_bounds__(kWarps * 32)
gather_order_count_kernel(const int32_t* __restrict__ ids, int64_t q, int64_t n_table, int shift,
                          int n_buckets, int32_t* __restrict__ counts) {
  __shared__ int hist[kOrderMaxBuckets];
  for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const int64_t t0 = (int64_t)blockIdx.x * kOrderTile;
  for (int i = threadIdx.x; i < kOrderTile; i += blockDim.x) {
    const int64_t p = t0 + i;
    if (p < q) atomicAdd(&hist[order_key(__ldg(ids + p), n_table, shift, n_buckets - 1)], 1);
  }
  __syncthreads();
  int32_t* row = counts + (int64_t)blockIdx.x * n_buckets;
  for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) row[b] = hist[b];
}

__global__ void __launch_bounds__(kWarps * 32)
gather_order_offsets_kernel(int32_t* __restrict__ counts, int tiles, int n_buckets,
                            int32_t* __restrict__ totals) {
  __shared__ int part[kWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  const int per = (tiles + kWarps - 1) / kWarps;
  const int lo = min(tiles, w * per), hi = min(tiles, lo + per);
  int sum = 0;
  if (b < n_buckets) {
#pragma unroll 8
    for (int t = lo; t < hi; ++t) sum += counts[(int64_t)t * n_buckets + b];
  }
  part[w][lane] = sum;
  __syncthreads();
  int run = 0;
  for (int v = 0; v < w; ++v) run += part[v][lane];
  if (b >= n_buckets) return;
  for (int t = lo; t < hi; ++t) {
    const int64_t k = (int64_t)t * n_buckets + b;
    const int c = counts[k];
    counts[k] = run;
    run += c;
  }
  if (w == kWarps - 1) totals[b] = run;
}

// Inclusive scans over the block of two values a thread (every thread of
// the block calls it); returns the exclusive prefixes.
__device__ __forceinline__ int2 block_exclusive_scan2(int2 v, int2* warp_sums) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int2 inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFull, inc.x, d), y = __shfl_up_sync(kFull, inc.y, d);
    if (lane >= d) inc.x += x, inc.y += y;
  }
  if (lane == 31) warp_sums[w] = inc;
  __syncthreads();
  int2 run = make_int2(inc.x - v.x, inc.y - v.y);
  for (int u = 0; u < w; ++u) run.x += warp_sums[u].x, run.y += warp_sums[u].y;
  return run;
}

__global__ void __launch_bounds__(kWarps * 32)
gather_order_scatter_kernel(const int32_t* __restrict__ ids, int64_t q, int64_t n_table,
                            int shift, int n_buckets, const int32_t* __restrict__ counts,
                            const int32_t* __restrict__ totals, int32_t* __restrict__ order,
                            int32_t* __restrict__ ids_in_order) {
  constexpr int kPer = kOrderMaxBuckets / (kWarps * 32);  // consecutive buckets a thread owns
  __shared__ int delta[kOrderMaxBuckets];          // a bucket's global slot less its tile slot
  __shared__ int slot[kWarps][kOrderMaxBuckets];   // a warp's count, then its next tile slot
  __shared__ int stage_pos[kOrderTile], stage_id[kOrderTile];  // the tile, bucket by bucket
  __shared__ int2 warp_sums[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int oob = n_buckets - 1;
  const int64_t t0 = (int64_t)blockIdx.x * kOrderTile;

  // every global load first: the totals and this tile's offsets of the
  // thread's buckets, the warp's positions and their buckets
  int tot[kPer], off[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int b = kPer * threadIdx.x + i;
    tot[i] = b < n_buckets ? __ldg(totals + b) : 0;
    off[i] = b < n_buckets ? __ldg(counts + (int64_t)blockIdx.x * n_buckets + b) : 0;
  }
  const int64_t p0 = t0 + (int64_t)w * 32 * kOrderSteps + lane;
  int id[kOrderSteps], key[kOrderSteps];
  unsigned group[kOrderSteps];
#pragma unroll
  for (int s = 0; s < kOrderSteps; ++s) {
    const int64_t p = p0 + 32 * s;
    id[s] = p < q ? __ldg(ids + p) : 0;
    key[s] = p < q ? order_key(id[s], n_table, shift, oob) : kOrderMaxBuckets;
  }
  for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) {
#pragma unroll
    for (int v = 0; v < kWarps; ++v) slot[v][b] = 0;
  }
  __syncthreads();

  // each warp's count per bucket, a step's lanes grouped by bucket
#pragma unroll
  for (int s = 0; s < kOrderSteps; ++s) {
    group[s] = same_key(key[s]);
    if (key[s] < n_buckets && lane == __ffs(group[s]) - 1) slot[w][key[s]] += __popc(group[s]);
    __syncwarp();
  }
  __syncthreads();

  // per bucket: the tile's count; the scans give the bucket's first global
  // slot (its total's prefix, plus this tile's offset) and its first tile
  // slot; each warp's first tile slot follows the earlier warps'
  int tile[kPer];
  int2 own = make_int2(0, 0);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int b = kPer * threadIdx.x + i;
    tile[i] = 0;
    if (b < n_buckets) {
#pragma unroll
      for (int v = 0; v < kWarps; ++v) tile[i] += slot[v][b];
    }
    own.x += tot[i];
    own.y += tile[i];
  }
  int2 run = block_exclusive_scan2(own, warp_sums);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int b = kPer * threadIdx.x + i;
    if (b < n_buckets) {
      delta[b] = run.x + off[i] - run.y;
      int r = run.y;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const int c = slot[v][b];
        slot[v][b] = r;
        r += c;
      }
    }
    run.x += tot[i];
    run.y += tile[i];
  }
  __syncthreads();

  // the tile's positions bucket by bucket into shared memory, in position
  // order within a bucket (warps, steps and lanes follow the positions)
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kOrderSteps; ++s) {
    const int leader = __ffs(group[s]) - 1;
    int base = 0;
    if (key[s] < n_buckets && lane == leader) {
      base = slot[w][key[s]];
      slot[w][key[s]] = base + __popc(group[s]);
    }
    base = __shfl_sync(kFull, base, leader);
    if (key[s] < n_buckets) {
      const int at = base + __popc(group[s] & below);
      stage_pos[at] = (int)(p0 + 32 * s);
      stage_id[at] = id[s];
    }
    __syncwarp();
  }
  __syncthreads();

  // out in tile order: a bucket's run of the tile lands on consecutive slots
  const int n_tile = (int)(q - t0 < kOrderTile ? q - t0 : kOrderTile);
  for (int j = threadIdx.x; j < n_tile; j += blockDim.x) {
    const int v = stage_id[j];
    const int at = j + delta[order_key(v, n_table, shift, oob)];
    order[at] = stage_pos[j];
    ids_in_order[at] = v;
  }
}

// counts: tiles x n_buckets int32 (tiles = ceil(q / kOrderTile)), totals:
// n_buckets int32, both scratch; order and ids_in_order: q int32 each.
extern "C" int tsg_gather_order(const void* ids, long long q, long long n_table, int shift,
                                int n_buckets, void* counts, void* totals, void* order,
                                void* ids_in_order, void* stream) {
  if (n_buckets < 1 || n_buckets > kOrderMaxBuckets || q < 0 || q > 0x7fffffffLL ||
      shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  if (q == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (int)((q + kOrderTile - 1) / kOrderTile);
  gather_order_count_kernel<<<tiles, kWarps * 32, 0, s>>>(
      (const int32_t*)ids, q, n_table, shift, n_buckets, (int32_t*)counts);
  gather_order_offsets_kernel<<<(n_buckets + 31) / 32, kWarps * 32, 0, s>>>(
      (int32_t*)counts, tiles, n_buckets, (int32_t*)totals);
  gather_order_scatter_kernel<<<tiles, kWarps * 32, 0, s>>>(
      (const int32_t*)ids, q, n_table, shift, n_buckets, (const int32_t*)counts,
      (const int32_t*)totals, (int32_t*)order, (int32_t*)ids_in_order);
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
