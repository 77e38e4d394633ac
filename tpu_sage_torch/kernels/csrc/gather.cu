// Row gather: out[i] = table[ids[i]], bitwise.
//
// Replaces tpu_sage/kernels/gather.py::gather_rows (manual row DMAs, with
// its jit wrapper gather_rows_pallas and the bf16 entry gather_rows_bf16 /
// bitcast_table_i32, which exist only because Mosaic cannot slice single
// rows of a packed bf16 buffer). Here the kernel is generic over the word it
// copies: the caller picks the widest of 16, 4, 2 or 1 bytes that divides
// the row and both base addresses. A 602-wide bf16 feature row is 1,204
// bytes and so only 4-byte aligned; an int32 adjacency row of 128 is 512
// bytes and moves as 16-byte words. Degrees gather as an (n, 1) view.
//
// Bound on the H100: bytes. The minimum traffic is the gathered rows read
// once and written once (15.4 MB each way for the 12,800-row bf16 feature
// gather). One warp owns one output row and walks it with consecutive lanes
// on consecutive words, so each row is read and written in full coalesced
// segments; the 8 warps of a block and the many blocks in flight keep
// enough independent row reads outstanding to cover the latency of the
// random row addresses. Row offsets are computed in 64 bits.
//
// Out-of-range ids follow the reference's two forms (tpu_sage/ops.py):
// oob_zero = 0 ("plain") wraps a negative id once by n, as Python indexing
// does, then clamps to [0, n); oob_zero = 1 ("masked") writes a zero row.

#include <cuda_runtime.h>
#include <cstdint>

template <typename W>
__global__ void gather_rows_kernel(const W* __restrict__ table,
                                   const int32_t* __restrict__ ids,
                                   W* __restrict__ out, int64_t n_table,
                                   int64_t q, int64_t row_words, int oob_zero) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= q) return;
  int64_t id = ids[row];
  W* dst = out + row * row_words;
  if (id < 0 || id >= n_table) {
    if (oob_zero) {
      for (int64_t j = lane; j < row_words; j += 32) dst[j] = W{};
      return;
    }
    if (id < 0) id += n_table;
    id = id < 0 ? 0 : (id >= n_table ? n_table - 1 : id);
  }
  const W* src = table + id * row_words;
  for (int64_t j = lane; j < row_words; j += 32) dst[j] = src[j];
}

template <typename W>
static void launch(const void* table, const void* ids, void* out, int64_t n_table,
                   int64_t q, int64_t row_words, int oob_zero, cudaStream_t stream) {
  const int warps = 8;
  const unsigned blocks = (unsigned)((q + warps - 1) / warps);
  gather_rows_kernel<W><<<blocks, warps * 32, 0, stream>>>(
      (const W*)table, (const int32_t*)ids, (W*)out, n_table, q, row_words, oob_zero);
}

extern "C" int tsg_gather_rows(const void* table, const void* ids, void* out,
                               long long n_table, long long q, long long row_bytes,
                               int word_bytes, int oob_zero, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t words = row_bytes / word_bytes;
  switch (word_bytes) {
    case 16: launch<uint4>(table, ids, out, n_table, q, words, oob_zero, s); break;
    case 4: launch<uint32_t>(table, ids, out, n_table, q, words, oob_zero, s); break;
    case 2: launch<uint16_t>(table, ids, out, n_table, q, words, oob_zero, s); break;
    case 1: launch<uint8_t>(table, ids, out, n_table, q, words, oob_zero, s); break;
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
// 128 threads per output row, walking the row in words of the width the
// caller picks (as for gather_rows). Bound on the H100: bytes, as for
// gather_rows; the design keeps one row per block on purpose, so a block's
// launch and retirement, not the bytes, set its rate, as the grid step does
// on the TPU. Out-of-range ids clamp as gather_rows's "clamp" form does
// (a negative id wraps once by n, then clamps to [0, n)), so no id reads
// outside the table.

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
