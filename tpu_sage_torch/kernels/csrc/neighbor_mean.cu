// Degree-masked neighbour mean: the exact pass's mean summary (mean, gcn,
// mean_pool).
//
//   out[v, :] = (sum over j < deg(v) of neigh[v, j, :]) / deg(v)   (deg(v) > 0)
//   out[v, :] = self_rows[v, :]                                    (deg(v) == 0)
//
// Replaces no Pallas kernel: it replaces XLA's masked sum in
// tpu_sage/nn/full_graph.py (the mean, gcn and mean_pool branches of the
// chunk summary: jnp.where(mask, x, 0).sum(axis=1) / deg, then the degree-0
// self-loop), which the port first wrote as torch's sum over the neighbour
// axis, the division by the clamped degree and a where, with the mask lines
// built beside them: eight launches a chunk. This kernel reads each node's
// rows j < deg(v) once, never the padding columns (zero rows in the exact
// pass), and writes each summary once. The arithmetic is the parent's: the
// sum in f32, rounded once to the table's dtype, then an IEEE division
// (__fdiv_rn, no reciprocal) by the degree in its dtype (f32, or bf16 where
// the caller's denominator is bf16), rounded to the table's dtype. Only the
// order of the sum differs from torch's reduction: GROUPS groups split the
// neighbour axis, group g adding rows g, g + GROUPS, ... in j order, and the
// groups' sums are added in g order, as the plain version
// kernels/neighbor_mean.py::neighbor_mean_ordered adds them, bitwise.
//
// Bound on the H100: bytes. The minimum traffic is each node's true rows
// read once and its summary written once: at the mean cell's layer-0 chunk
// (4,096 nodes, 128 neighbours, 602 f32 features) 1,262.5 MB read and 9.9 MB
// written, 0.380 ms at 3.35 TB/s; at layer 1 (256 f32) 536.9 + 4.2 MB,
// 0.1615 ms. The work is pure streaming. The design goes after that bound:
//
// * one block a node, blockDim = (LANES, GROUPS) (the wrapper's plan:
//   kernels/neighbor_mean.py::neighbor_mean_plan); the LANES threads of a
//   group read whole rows, each thread K words of a row (lane, lane +
//   LANES, ...), so a warp's loads are contiguous; a row wider than
//   LANES x K words takes several turns;
// * the word is the widest of 16, 8 and 4 bytes that the width, the strides
//   and the three base addresses all allow, else the element: layer 0's
//   2,408-byte f32 rows, where every other row starts 8 bytes off a 16-byte
//   boundary, take 8-byte words rather than 4-byte elements;
// * each thread issues the loads of 4 of its group's rows (4 K words; 8
//   rows where K = 1) before it adds any of them, in order;
// * the loads are streaming (ld.global.cs, evict-first): each row is read
//   once, so it should not push out of L2 the next chunk's gathered rows;
// * the groups' sums meet in shared memory, and group 0 writes the summary.
//
// Measured on the H100 at the cell's chunks (L2-cold), 64 lanes x 4 groups,
// K = 5 (layer 0) and K = 1 (layer 1): 0.402 and 0.1725 ms, 94.5 and 93.6 %
// of the bound, where torch's sum alone took 0.422 and 0.179, and one thread
// a column summing all 128 rows in j order 0.415 and 0.178.
//
// Elements are f32 or bf16 (a bf16 widened to f32 exactly). Strides are in
// words and may be anything the word divides: a view such as neigh[:, :keep]
// runs without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

static constexpr int kMaxThreads = 256;  // LANES x GROUPS at most
static constexpr int kLanes = 64;        // LANES wherever K > 1, so k x kLanes is an immediate
static constexpr int kMaxWords = 8;      // K at most; K x word <= 64 bytes

// A group's rows whose loads a thread has in flight: 8 for one word a row,
// else 4 (4 K words). At the cell's chunks 4 rows for K = 1 lost 1 %.
template <int K> struct Tune {
  static constexpr int kRows = K == 1 ? 8 : 4;
};

template <int EB> struct Elem;
template <> struct Elem<4> {  // f32: divide the sum
  using T = uint32_t;
  static __device__ __forceinline__ float to_f(T b) { return __uint_as_float(b); }
  static __device__ __forceinline__ T mean(float sum, float denom) {
    return __float_as_uint(__fdiv_rn(sum, denom));
  }
};
template <> struct Elem<2> {  // bf16: round the sum once, divide, round
  using T = uint16_t;
  static __device__ __forceinline__ float to_f(T b) { return __uint_as_float(uint32_t(b) << 16); }
  static __device__ __forceinline__ T to_bf16(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  static __device__ __forceinline__ T mean(float sum, float denom) {
    return to_bf16(__fdiv_rn(to_f(to_bf16(sum)), denom));
  }
};

// A word W of N = sizeof(W) / EB elements, summed element by element in f32.
template <int EB, typename W> struct Word {
  using E = Elem<EB>;
  using T = typename E::T;
  static constexpr int N = sizeof(W) / EB;
  union Bits {
    W w;
    T e[N];
  };
  static __device__ __forceinline__ W load(const W* p) { return __ldcs(p); }
  static __device__ __forceinline__ void add(float* acc, W w) {
    Bits b;
    b.w = w;
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] += E::to_f(b.e[k]);
  }
  static __device__ __forceinline__ W mean(const float* acc, float denom) {
    Bits b;
#pragma unroll
    for (int k = 0; k < N; ++k) b.e[k] = E::mean(acc[k], denom);
    return b.w;
  }
};

// Two blocks an SM (at most 128 registers): at the cell's chunks no cap
// lost 1-3 % (92 and 40 registers), three blocks (80) up to 2 %.
template <int EB, typename W, int K>
__global__ void __launch_bounds__(kMaxThreads, 2)
neighbor_mean_kernel(const W* __restrict__ neigh, const int32_t* __restrict__ degrees,
                     const W* __restrict__ self_rows, W* __restrict__ out, int64_t max_degree,
                     int64_t row_words, int64_t node_stride, int64_t neigh_stride,
                     int64_t self_stride, int degree_bf16) {
  using Wd = Word<EB, W>;
  constexpr int N = Wd::N;
  constexpr int kRows = Tune<K>::kRows;
  extern __shared__ float part[];  // groups 1, 2, ...: K x N sums a lane
  const int64_t v = blockIdx.x;
  const int lane = threadIdx.x, g = threadIdx.y, lanes = blockDim.x, groups = blockDim.y;
  const int32_t deg = degrees[v];
  W* o = out + v * row_words;
  if (deg == 0) {  // the self-loop: the node's own row
    const W* s = self_rows + v * self_stride;
    for (int64_t c = (int64_t)g * lanes + lane; c < row_words; c += (int64_t)lanes * groups)
      o[c] = s[c];
    return;
  }
  const int64_t count = deg < 0 ? 0 : (deg < max_degree ? deg : max_degree);
  float denom = __int2float_rn(deg < 1 ? 1 : deg);  // the parent's clamp_min(1)
  if (degree_bf16) denom = __bfloat162float(__float2bfloat16_rn(denom));
  for (int64_t c0 = 0; c0 < row_words; c0 += (int64_t)lanes * K) {  // a turn: LANES x K words
    const W* p = neigh + v * node_stride + c0 + lane;
    bool live[K];
    float acc[K][N];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      live[k] = c0 + lane + k * kLanes < row_words;
#pragma unroll
      for (int n = 0; n < N; ++n) acc[k][n] = 0.0f;
    }
    int64_t j = g;
    for (; j + (int64_t)(kRows - 1) * groups < count; j += (int64_t)kRows * groups) {
      W w[kRows][K];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (live[k])
            w[u][k] = Wd::load(p + (j + (int64_t)u * groups) * neigh_stride + k * kLanes);
#pragma unroll
      for (int u = 0; u < kRows; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (live[k]) Wd::add(acc[k], w[u][k]);
    }
#pragma unroll 1
    for (; j < count; j += groups)
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (live[k]) Wd::add(acc[k], Wd::load(p + j * neigh_stride + k * kLanes));
    if (groups > 1) {  // group 0 adds the other groups' sums in g order
      if (g > 0) {
        float* mine = part + (int64_t)(g - 1) * K * N * lanes + lane;
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int n = 0; n < N; ++n) mine[(k * N + n) * lanes] = acc[k][n];
      }
      __syncthreads();
      if (g == 0) {
        for (int h = 1; h < groups; ++h) {
          const float* theirs = part + (int64_t)(h - 1) * K * N * lanes + lane;
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int n = 0; n < N; ++n) acc[k][n] += theirs[(k * N + n) * lanes];
        }
      }
      __syncthreads();  // the next turn writes the shared sums again
    }
    if (g == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (live[k]) o[c0 + lane + k * kLanes] = Wd::mean(acc[k], denom);
    }
  }
}

template <int EB, typename W, int K>
static int launch(const void* neigh, const void* degrees, const void* self_rows, void* out,
                  int64_t rows, int64_t max_degree, int64_t row_words, int64_t node_stride,
                  int64_t neigh_stride, int64_t self_stride, int lanes, int groups,
                  int degree_bf16, cudaStream_t s) {
  if (((uintptr_t)neigh | (uintptr_t)self_rows | (uintptr_t)out) % sizeof(W))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(groups - 1) * K * Word<EB, W>::N * lanes * sizeof(float);
  neighbor_mean_kernel<EB, W, K><<<(unsigned)rows, dim3(lanes, groups), smem, s>>>(
      (const W*)neigh, (const int32_t*)degrees, (const W*)self_rows, (W*)out, max_degree,
      row_words, node_stride, neigh_stride, self_stride, degree_bf16);
  return 0;
}

// K words a thread, 1 to kMaxWords and K x sizeof(W) <= 64 (other K map to
// a launch that is never taken).
template <int EB, typename W>
static int launch_k(int k, const void* neigh, const void* degrees, const void* self_rows,
                    void* out, int64_t rows, int64_t max_degree, int64_t row_words,
                    int64_t node_stride, int64_t neigh_stride, int64_t self_stride, int lanes,
                    int groups, int degree_bf16, cudaStream_t s) {
  if (k * sizeof(W) > 64) return (int)cudaErrorInvalidValue;
  switch (k) {
#define TSG_K(K)                                                                           \
  case K:                                                                                  \
    return launch<EB, W, (K * sizeof(W) <= 64 ? K : 1)>(                                   \
        neigh, degrees, self_rows, out, rows, max_degree, row_words, node_stride,          \
        neigh_stride, self_stride, lanes, groups, degree_bf16, s)
    TSG_K(1); TSG_K(2); TSG_K(3); TSG_K(4); TSG_K(5); TSG_K(6); TSG_K(7); TSG_K(8);
#undef TSG_K
  }
  return (int)cudaErrorInvalidValue;
}

// Strides and row_words are in words of word_bytes (16, 8 or 4, or the
// element's elem_bytes: 4 for f32, 2 for bf16); one block a node of lanes x
// groups threads, at most 256, each thread k words of a row a turn (1 to 8,
// k x word_bytes <= 64; lanes 64 where k > 1); degree_bf16 divides by the
// degree rounded to bf16.
extern "C" int tsg_neighbor_mean(const void* neigh, const void* degrees, const void* self_rows,
                                 void* out, long long rows, long long max_degree,
                                 long long row_words, long long node_stride,
                                 long long neigh_stride, long long self_stride, int elem_bytes,
                                 int word_bytes, int lanes, int groups, int k, int degree_bf16,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows < 0 || rows > INT_MAX || max_degree < 1 || row_words < 1 || lanes < 1 ||
      groups < 1 || lanes > kMaxThreads || groups > kMaxThreads ||
      lanes * groups > kMaxThreads || k < 1 || k > kMaxWords || (k > 1 && lanes != kLanes))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  int rc = (int)cudaErrorInvalidValue;
#define TSG_MEAN(EB, W)                                                                      \
  rc = launch_k<EB, W>(k, neigh, degrees, self_rows, out, rows, max_degree, row_words,       \
                       node_stride, neigh_stride, self_stride, lanes, groups, degree_bf16, s)
  if (elem_bytes == 4) {
    switch (word_bytes) {
      case 16: TSG_MEAN(4, uint4); break;
      case 8: TSG_MEAN(4, uint2); break;
      case 4: TSG_MEAN(4, uint32_t); break;
    }
  } else if (elem_bytes == 2) {
    switch (word_bytes) {
      case 16: TSG_MEAN(2, uint4); break;
      case 8: TSG_MEAN(2, uint2); break;
      case 4: TSG_MEAN(2, uint32_t); break;
      case 2: TSG_MEAN(2, uint16_t); break;
    }
  }
#undef TSG_MEAN
  if (rc) return rc;
  return (int)cudaGetLastError();
}
