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
// * realign (rows wider than 128 bytes whose width and bases are multiples
//   of 4, except rows of at most 512 bytes that are 16-byte aligned on both
//   sides, which the words form moves one 16-byte word per lane): the main
//   path's rows. A 602-wide bf16 feature row is 1,204 bytes
//   and so only 4-byte aligned, and the source offset (4·id mod 16) and the
//   destination offset (4·r mod 16) differ from row to row. One warp owns a
//   row. Each lane loads the aligned 16-byte words that cover the source
//   span (lane l takes words l, l + 32, ...), all WPL of them (a template
//   argument: words per lane, so the loads are unrolled and all issued
//   before the first store), then realigns them to the destination by
//   taking 4-byte components from its own word and its neighbour's
//   (__shfl_down_sync), and stores aligned 16-byte words in the row's
//   interior and 4-byte words at its head and tail. Rows wider than
//   32·WPL words go in chunks of that many. A 16-byte word that reaches
//   outside the table's bytes (possible only at the first and last rows,
//   when the table's ends are not 16-byte aligned) is read component by
//   component, only inside the table.
// * words (everything else): the widest word of 16, 4, 2 or 1 bytes that
//   divides the row and both bases; a power-of-two group of lanes per row
//   (so a 4-byte row, the (n, 1) degree view, puts 32 rows in a warp, and a
//   512-byte int32 adjacency row of 16-byte words one row in a warp, one
//   word per lane); rows whose width or base is not a multiple of 4 walk
//   their row in 2- or 1-byte words.
//
// In both forms the ids of a warp's rows are loaded once, coalesced, and
// shared by shuffle; table words are read through the non-coherent path.
//
// Bound on the H100: bytes. The minimum traffic is the ids, the gathered
// rows read once and written once: 15.4 MB each way for the 12,800-row bf16
// feature gather (0.0087 ms at 3.35 TB/s), 0.6 MB each way at 512 rows. The
// realign form issues a warp's whole row, 76 16-byte words, before its first
// store. Measured on the H100 (PERF.md), it moves rows at about 2.6 TB/s of
// reads and writes together once the first loads return, as a loop of 4-byte
// load-store steps per lane also does at 12,800 rows; what stands above the
// bound is the launch and the two dependent loads (the id, then the row)
// before any row moves: 0.006 ms alone at 512 rows.
//
// -Xptxas -v (nvcc 12.8, sm_90a): realign<1, 2, 3, 4 words per lane> 34, 42,
// 56, 64 registers; words form 20-26; no spills.
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

template <typename W>
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
  const int sub = lane - r * lanes_per_row;
  if (id < 0) {
    for (int64_t j = sub; j < row_words; j += lanes_per_row) dst[j] = W{};
    return;
  }
  const W* src = table + id * row_words;
  for (int64_t j = sub; j < row_words; j += lanes_per_row) dst[j] = __ldg(src + j);
}

// ---- the realign form ------------------------------------------------------

// The aligned 16-byte word at byte address a; components outside
// [lo, hi) (the table's bytes) are never read and come back 0.
__device__ __forceinline__ uint4 load_word(uintptr_t a, uintptr_t lo, uintptr_t hi) {
  if (a >= lo && a + 16 <= hi) return __ldg(reinterpret_cast<const uint4*>(a));
  uint32_t c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uintptr_t ai = a + 4 * i;
    c[i] = (ai >= lo && ai < hi) ? __ldg(reinterpret_cast<const uint32_t*>(ai)) : 0u;
  }
  return make_uint4(c[0], c[1], c[2], c[3]);
}

// Components sh .. sh + 3 of the eight in (a, b).
__device__ __forceinline__ uint4 funnel(uint4 a, uint4 b, int sh) {
  switch (sh) {
    case 0: return a;
    case 1: return make_uint4(a.y, a.z, a.w, b.x);
    case 2: return make_uint4(a.z, a.w, b.x, b.y);
    default: return make_uint4(a.w, b.x, b.y, b.z);
  }
}

__device__ __forceinline__ uint4 shfl_down_word(uint4 v, int delta) {
  return make_uint4(__shfl_down_sync(kFull, v.x, delta), __shfl_down_sync(kFull, v.y, delta),
                    __shfl_down_sync(kFull, v.z, delta), __shfl_down_sync(kFull, v.w, delta));
}

__device__ __forceinline__ uint4 shfl_word(uint4 v, int src) {
  return make_uint4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                    __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src));
}

// Store the aligned 16-byte word w at byte address a, only its components
// inside [lo, hi) (the destination row).
__device__ __forceinline__ void store_word(uintptr_t a, uint4 w, uintptr_t lo, uintptr_t hi) {
  if (a >= lo && a + 16 <= hi) {
    *reinterpret_cast<uint4*>(a) = w;
    return;
  }
  const uint32_t c[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uintptr_t ai = a + 4 * i;
    if (ai >= lo && ai < hi) *reinterpret_cast<uint32_t*>(ai) = c[i];
  }
}

template <int WPL>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows_realign_kernel(const uint8_t* __restrict__ table, const int32_t* __restrict__ ids,
                           uint8_t* __restrict__ out, int64_t n_table, int64_t q,
                           int64_t row_bytes, int oob_zero) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= q) return;  // uniform over the warp
  const int64_t id =
      resolve_id(__shfl_sync(kFull, lane == 0 ? __ldg(ids + row) : 0, 0), n_table, oob_zero);

  const uintptr_t tlo = reinterpret_cast<uintptr_t>(table);
  const uintptr_t thi = tlo + (uintptr_t)(n_table * row_bytes);
  const uintptr_t s = tlo + (uintptr_t)((id < 0 ? 0 : id) * row_bytes);
  const uintptr_t d = reinterpret_cast<uintptr_t>(out) + (uintptr_t)(row * row_bytes);
  const uintptr_t s0 = s & ~(uintptr_t)15, d0 = d & ~(uintptr_t)15;
  // destination word j (at d0 + 16 j) holds source components sh .. sh + 3
  // of words j + f and j + f + 1 of the source span (at s0 + 16 k)
  const int delta = (int)(s - s0) - (int)(d - d0);  // -12 .. 12, a multiple of 4
  const int f = delta < 0 ? -1 : 0;
  const int sh = (delta - 16 * f) >> 2;
  const int64_t n_src = ((int64_t)(s - s0) + row_bytes + 15) >> 4;
  const int64_t n_dst = ((int64_t)(d - d0) + row_bytes + 15) >> 4;

  for (int64_t base = 0; base < n_dst; base += 32 * WPL) {
    uint4 v[WPL + 1];
#pragma unroll
    for (int i = 0; i <= WPL; ++i) {
      // word WPL of the chunk only feeds lane 31's last store: lane 0 loads it
      const int64_t k = base + lane + 32 * i + f;
      v[i] = (id >= 0 && k >= 0 && k < n_src && (i < WPL || lane == 0))
                 ? load_word(s0 + 16 * k, tlo, thi)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      uint4 next = shfl_down_word(v[i], 1);
      const uint4 wrap = shfl_word(v[i + 1], 0);
      if (lane == 31) next = wrap;
      const int64_t j = base + lane + 32 * i;
      if (j < n_dst) store_word(d0 + 16 * j, funnel(v[i], next, sh), d, d + row_bytes);
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
  gather_rows_words_kernel<W><<<blocks, kWarps * 32, 0, stream>>>(
      (const W*)table, (const int32_t*)ids, (W*)out, n_table, q, row_words, lanes_per_row,
      oob_zero);
}

template <int WPL>
static void launch_realign(const void* table, const void* ids, void* out, int64_t n_table,
                           int64_t q, int64_t row_bytes, int oob_zero, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((q + kWarps - 1) / kWarps);
  gather_rows_realign_kernel<WPL><<<blocks, kWarps * 32, 0, stream>>>(
      (const uint8_t*)table, (const int32_t*)ids, (uint8_t*)out, n_table, q, row_bytes,
      oob_zero);
}

// words_per_lane in 1..4 takes the realign form (row and both bases multiples
// of 4 bytes; word_bytes and lanes_per_row unused); 0 takes the words form with
// word_bytes in {16, 4, 2, 1} dividing the row and both bases and
// lanes_per_row a power of two up to 32.
extern "C" int tsg_gather_rows(const void* table, const void* ids, void* out,
                               long long n_table, long long q, long long row_bytes,
                               int word_bytes, int lanes_per_row, int words_per_lane,
                               int oob_zero, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (words_per_lane > 0) {
    if (row_bytes % 4 || ((uintptr_t)table | (uintptr_t)out) % 4)
      return (int)cudaErrorInvalidValue;
    switch (words_per_lane) {
      case 1: launch_realign<1>(table, ids, out, n_table, q, row_bytes, oob_zero, s); break;
      case 2: launch_realign<2>(table, ids, out, n_table, q, row_bytes, oob_zero, s); break;
      case 3: launch_realign<3>(table, ids, out, n_table, q, row_bytes, oob_zero, s); break;
      case 4: launch_realign<4>(table, ids, out, n_table, q, row_bytes, oob_zero, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
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
