// Gather + fanout mean in one pass: out[r] = mean_j table[ids[r*F + j]], f32.
//
// Replaces tpu_sage/kernels/gather_mean.py::gather_fanout_mean, which DMAs
// a root tile's rows into VMEM and reduces them there so the (R*F, d)
// gathered block never reaches HBM. Its Mosaic workarounds (int32 bit view
// of bf16, <=128-lane column chunks, deinterleaved lanes) have no purpose
// on Hopper and are not carried over.
//
// Bound on the H100: bytes. The rows must be read once (128,000 bf16 rows
// of 1,204 bytes at the deepest level of the (25, 10) tree, fewer distinct
// ones where ids repeat) and the f32 means written once (12,800 x 602 x 4 =
// 30.8 MB). The design keeps many independent row reads in flight:
//   - one warp per root, 4 roots per block; the warp's first F lanes load
//     the root's ids once (clamped), and __shfl_sync hands each id to all;
//   - each row is read in words of V elements (bf16: 4, 8 or 16 bytes, a
//     1,204-byte row as 301 bf16x2 words; f32: 8 bytes), consecutive lanes
//     on consecutive words, with non-coherent loads that skip L1;
//   - per pass a lane holds about 20 columns (10 bf16x2 words) of kJ = 5
//     rows, 50 loads in flight: a root's F = 10 rows are issued in two
//     halves of five, each half before any of its words is added, and a
//     301-word row is one pass;
//   - the sum runs in f32 in the order j = 0, 1, ... (the first row starts
//     it, as the plain version's does), then is divided by F, so the result
//     is bitwise the plain version's;
//   - each lane writes its V means as float2 (or float) stores; a 2,408-byte
//     output row is 8-byte aligned.
//
// Out-of-range ids take the "plain" form of tpu_sage/ops.py: a negative id
// wraps once by n, then the id clamps to [0, n).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 4;  // roots per block
constexpr int kJ = 5;      // rows whose loads are in flight together

// words per lane per pass: about 20 columns (a 301-word bf16x2 row in one pass)
template <int V> struct WordsPerLane { static constexpr int value = V >= 8 ? 2 : (V == 4 ? 5 : 10); };

template <int BYTES> struct Word;
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

__device__ __forceinline__ void ld_nc(uint16_t& v, const void* p) {
  asm volatile("ld.global.nc.L1::no_allocate.b16 %0, [%1];\n" : "=h"(v) : "l"(p));
}
__device__ __forceinline__ void ld_nc(uint32_t& v, const void* p) {
  asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
}
__device__ __forceinline__ void ld_nc(uint2& v, const void* p) {
  asm volatile("ld.global.nc.L1::no_allocate.v2.b32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "l"(p));
}
__device__ __forceinline__ void ld_nc(uint4& v, const void* p) {
  asm volatile("ld.global.nc.L1::no_allocate.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
}

// the i-th 32-bit lane of a word
__device__ __forceinline__ uint32_t part(uint16_t v, int) { return v; }
__device__ __forceinline__ uint32_t part(uint32_t v, int) { return v; }
__device__ __forceinline__ uint32_t part(uint2 v, int i) { return i == 0 ? v.x : v.y; }
__device__ __forceinline__ uint32_t part(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// element e of a word of V elements of T, as f32
template <typename T, int V, typename W>
__device__ __forceinline__ float element(const W& v, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(part(v, e));
  } else if constexpr (V == 1) {
    return __uint_as_float(part(v, 0) << 16);
  } else {
    const uint32_t p = part(v, e >> 1);
    return __uint_as_float((e & 1) ? (p & 0xffff0000u) : (p << 16));
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kWarps * 32)
gather_fanout_mean_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                          float* __restrict__ out, int64_t n_table, int64_t n_roots, int d,
                          int fanout) {
  using W = typename Word<sizeof(T) * V>::T;
  constexpr int kK = WordsPerLane<V>::value;
  const int lane = threadIdx.x & 31;
  const int64_t root = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (root >= n_roots) return;
  const int32_t* root_ids = ids + root * fanout;
  const int words = d / V;
  float* dst = out + root * d;

  auto load_id = [&](int j) -> int64_t {
    if (j >= fanout) return 0;
    int64_t id = root_ids[j];
    if (id < 0) id += n_table;
    return id < 0 ? 0 : (id >= n_table ? n_table - 1 : id);
  };
  const int64_t first_ids = load_id(lane);  // ids 0..31, loaded once

#pragma unroll 1
  for (int w0 = 0; w0 < words; w0 += 32 * kK) {
    float acc[kK][V] = {};
#pragma unroll 1
    for (int jb = 0; jb < fanout; jb += 32) {
      const int64_t my_id = jb == 0 ? first_ids : load_id(jb + lane);
      const int jend = min(fanout, jb + 32);  // the ids this block of lanes holds
#pragma unroll 1
      for (int j0 = jb; j0 < jend; j0 += kJ) {
        W v[kJ][kK];
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const int64_t id = __shfl_sync(0xffffffffu, my_id, j0 - jb + jj);
          const W* row = reinterpret_cast<const W*>(table + id * d);
#pragma unroll
          for (int k = 0; k < kK; ++k) {
            const int wi = w0 + k * 32 + lane;
            if (j0 + jj < jend && wi < words) ld_nc(v[jj][k], row + wi);
          }
        }
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          if (j0 + jj < jend) {
#pragma unroll
            for (int k = 0; k < kK; ++k)
#pragma unroll
              for (int e = 0; e < V; ++e) {
                const float x = element<T, V>(v[jj][k], e);
                acc[k][e] = (j0 + jj == 0) ? x : acc[k][e] + x;
              }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int wi = w0 + k * 32 + lane;
      if (wi < words) {
        float* o = dst + (int64_t)wi * V;
        if constexpr (V == 1) {
          o[0] = acc[k][0] / (float)fanout;
        } else {
#pragma unroll
          for (int e = 0; e < V; e += 2)
            *reinterpret_cast<float2*>(o + e) =
                make_float2(acc[k][e] / (float)fanout, acc[k][e + 1] / (float)fanout);
        }
      }
    }
  }
}

template <typename T, int V>
void launch(const void* table, const void* ids, void* out, int64_t n_table, int64_t n_roots,
            int d, int fanout, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n_roots + kWarps - 1) / kWarps);
  gather_fanout_mean_kernel<T, V><<<blocks, kWarps * 32, 0, s>>>(
      (const T*)table, (const int32_t*)ids, (float*)out, n_table, n_roots, d, fanout);
}

}  // namespace

// vec: elements per word, picked by the caller as the widest that divides d
// and the table's base address in bytes (bf16: 8, 4, 2 or 1; f32: 2 or 1);
// the output's base is 8-byte aligned.
extern "C" int tsg_gather_fanout_mean(const void* table, const void* ids, void* out,
                                      long long n_table, long long n_roots, int d,
                                      int fanout, int is_bf16, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    switch (vec) {
      case 8: launch<__nv_bfloat16, 8>(table, ids, out, n_table, n_roots, d, fanout, s); break;
      case 4: launch<__nv_bfloat16, 4>(table, ids, out, n_table, n_roots, d, fanout, s); break;
      case 2: launch<__nv_bfloat16, 2>(table, ids, out, n_table, n_roots, d, fanout, s); break;
      case 1: launch<__nv_bfloat16, 1>(table, ids, out, n_table, n_roots, d, fanout, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (vec) {
      case 2: launch<float, 2>(table, ids, out, n_table, n_roots, d, fanout, s); break;
      case 1: launch<float, 1>(table, ids, out, n_table, n_roots, d, fanout, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8 rows: tsg_gather_fanout_mean_int8.
//
// Replaces tpu_sage/data/quantize.py::QuantizedFeats.fanout_mean (XLA in the
// JAX package, no Pallas form): the deepest level's gather + fanout mean
// over an int8 table with per-column scales. Two modes:
//
//   summean = 1 (JAX's int8_summean=True, the default):
//     s[r, j]   = sum_f q[ids[r*F + f], j]                in int32 (exact)
//     out[r, j] = round_dt(fl32(float(s) * c[j]))
//   with c[j] = fl32(scale[j] * fl32(1/F)) (fl32(1/F) = __frcp_rn(F)): the
//   form the reference takes under jit, where XLA rewrites scale / F as a
//   product with the reciprocal;
//   summean = 0 (int8_summean=False, dequantize then mean), in the form the
//   reference's jnp.mean of the dequantized rows takes under jit on the CPU:
//     bf16: x[f, j] = round_bf16(fl32(float(q) * scale_bf16[j])), summed in
//           f32 in order f = 0, 1, ...;
//     f32:  acc = fma(float(q), scale[j], acc) in order f = 0, 1, ... (XLA
//           contracts the dequantizing multiply into the sum);
//     out[r, j] = round_dt(fl32(acc * fl32(1/F)))
//   with scale_dt = round_dt(scale). The kernel reads the f32 scales and
//   derives both factors itself, so a step launches nothing else for them.
//
// out is in the compute dtype (bf16 or f32). Bitwise the plain version
// (kernels/gather_mean.py::gather_fanout_mean_int8_reference) in both modes.
//
// Bound on the H100: bytes. At the main path's deepest level (12,800 roots,
// F = 10, 602 columns) the rows are 128,000 x 602 B = 77.1 MB (about 80 MB
// in 32-byte sectors, fewer where ids repeat), the ids 0.5 MB and the bf16
// means 15.4 MB: about 96 MB, 0.029 ms at 3.35 TB/s, against 0.044 ms for
// the bf16 table's rows and f32 means above. The design is the dense
// kernel's: one warp per root, ids shuffled from the first F lanes, kJ = 5
// rows' loads issued before any is added. A row starts at id * d bytes, so
// a 602-byte row is only 2-byte aligned: the word is the widest of 16, 8,
// 4, 2 or 1 bytes that divides d and the table's address (a 602-wide row
// moves as 301 two-byte words, 10 per lane, one pass); the sum of a word's
// bytes runs in int32 registers (exact for F < 2^24).

namespace {

template <int V> struct Int8WordsPerLane {
  static constexpr int value = V >= 16 ? 1 : (V == 8 ? 2 : (V == 4 ? 5 : 10));
};

template <int BYTES> struct Int8Word;
template <> struct Int8Word<1> { using T = uint8_t; };
template <> struct Int8Word<2> { using T = uint16_t; };
template <> struct Int8Word<4> { using T = uint32_t; };
template <> struct Int8Word<8> { using T = uint2; };
template <> struct Int8Word<16> { using T = uint4; };

__device__ __forceinline__ void ld_nc(uint8_t& v, const void* p) {
  v = __ldg(reinterpret_cast<const unsigned char*>(p));
}
__device__ __forceinline__ uint32_t part(uint8_t v, int) { return v; }

// byte e of a word, sign-extended
template <typename W>
__device__ __forceinline__ int byte_of(const W& v, int e) {
  return (int)(int8_t)(uint8_t)(part(v, e >> 2) >> (8 * (e & 3)));
}

__device__ __forceinline__ float round_out(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 round_out(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// two adjacent outputs in one store (4 bytes of bf16, 8 of f32)
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int V, int SUMMEAN, typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
gather_fanout_mean_int8_kernel(const int8_t* __restrict__ table, const int32_t* __restrict__ ids,
                               const float* __restrict__ scale, OutT* __restrict__ out,
                               int64_t n_table, int64_t n_roots, int d, int fanout) {
  using W = typename Int8Word<V>::T;
  using Acc = typename std::conditional<SUMMEAN, int, float>::type;
  constexpr int kK = Int8WordsPerLane<V>::value;
  const int lane = threadIdx.x & 31;
  const int64_t root = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (root >= n_roots) return;
  const int32_t* root_ids = ids + root * fanout;
  const int words = d / V;
  OutT* dst = out + root * d;

  auto load_id = [&](int j) -> int64_t {
    if (j >= fanout) return 0;
    int64_t id = root_ids[j];
    if (id < 0) id += n_table;
    return id < 0 ? 0 : (id >= n_table ? n_table - 1 : id);
  };
  const int64_t first_ids = load_id(lane);

#pragma unroll 1
  for (int w0 = 0; w0 < words; w0 += 32 * kK) {
    Acc acc[kK][V] = {};
    float scale_dt[kK][V];  // summean = 0: each column's scale in the compute dtype
    if constexpr (!SUMMEAN) {
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const int wi = w0 + k * 32 + lane;
#pragma unroll
        for (int e = 0; e < V; ++e)
          scale_dt[k][e] =
              wi < words ? widen(round_out(scale[wi * V + e], (OutT*)nullptr)) : 0.f;
      }
    }
#pragma unroll 1
    for (int jb = 0; jb < fanout; jb += 32) {
      const int64_t my_id = jb == 0 ? first_ids : load_id(jb + lane);
      const int jend = min(fanout, jb + 32);  // the ids this block of lanes holds
#pragma unroll 1
      for (int j0 = jb; j0 < jend; j0 += kJ) {
        W v[kJ][kK];
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const int64_t id = __shfl_sync(0xffffffffu, my_id, j0 - jb + jj);
          const W* row = reinterpret_cast<const W*>(table + id * d);
#pragma unroll
          for (int k = 0; k < kK; ++k) {
            const int wi = w0 + k * 32 + lane;
            if (j0 + jj < jend && wi < words) ld_nc(v[jj][k], row + wi);
          }
        }
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          if (j0 + jj < jend) {
#pragma unroll
            for (int k = 0; k < kK; ++k)
#pragma unroll
              for (int e = 0; e < V; ++e) {
                const int qv = byte_of(v[jj][k], e);
                if constexpr (SUMMEAN) {
                  acc[k][e] += qv;
                } else if constexpr (std::is_same<OutT, float>::value) {
                  acc[k][e] = __fmaf_rn((float)qv, scale_dt[k][e], acc[k][e]);
                } else {
                  acc[k][e] = __fadd_rn(acc[k][e], widen(round_out(
                      __fmul_rn((float)qv, scale_dt[k][e]), (OutT*)nullptr)));
                }
              }
          }
        }
      }
    }
    const float recip = __frcp_rn((float)fanout);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int wi = w0 + k * 32 + lane;
      if (wi < words) {
        float m[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if constexpr (SUMMEAN) {
            m[e] = __fmul_rn((float)acc[k][e], __fmul_rn(scale[wi * V + e], recip));
          } else {
            m[e] = __fmul_rn(acc[k][e], recip);
          }
        }
        if constexpr (V == 1) {
          dst[wi] = round_out(m[0], (OutT*)nullptr);
        } else {  // V even: a word's outputs start at an even element
#pragma unroll
          for (int e = 0; e < V; e += 2) store_pair(dst + wi * V + e, m[e], m[e + 1]);
        }
      }
    }
  }
}

template <int V, int SUMMEAN, typename OutT>
void launch_int8(const void* table, const void* ids, const void* scale, void* out,
                 int64_t n_table, int64_t n_roots, int d, int fanout, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n_roots + kWarps - 1) / kWarps);
  gather_fanout_mean_int8_kernel<V, SUMMEAN, OutT><<<blocks, kWarps * 32, 0, s>>>(
      (const int8_t*)table, (const int32_t*)ids, (const float*)scale, (OutT*)out, n_table,
      n_roots, d, fanout);
}

template <int V>
int launch_int8_mode(const void* table, const void* ids, const void* scale, void* out,
                     int64_t n_table, int64_t n_roots, int d, int fanout, int out_bf16,
                     int summean, cudaStream_t s) {
  if (summean && out_bf16)
    launch_int8<V, 1, __nv_bfloat16>(table, ids, scale, out, n_table, n_roots, d, fanout, s);
  else if (summean)
    launch_int8<V, 1, float>(table, ids, scale, out, n_table, n_roots, d, fanout, s);
  else if (out_bf16)
    launch_int8<V, 0, __nv_bfloat16>(table, ids, scale, out, n_table, n_roots, d, fanout, s);
  else
    launch_int8<V, 0, float>(table, ids, scale, out, n_table, n_roots, d, fanout, s);
  return (int)cudaGetLastError();
}

}  // namespace

// scale: (d,) f32 per-column scales. vec: bytes per word, the widest of 16,
// 8, 4, 2, 1 that divides d and the table's base address; out (n_roots, d)
// bf16 (out_bf16 = 1) or f32, its base 8-byte aligned.
extern "C" int tsg_gather_fanout_mean_int8(const void* table, const void* ids,
                                           const void* scale, void* out, long long n_table,
                                           long long n_roots, int d, int fanout, int out_bf16,
                                           int summean, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (vec) {
    case 16: return launch_int8_mode<16>(table, ids, scale, out, n_table, n_roots, d, fanout,
                                         out_bf16, summean, s);
    case 8: return launch_int8_mode<8>(table, ids, scale, out, n_table, n_roots, d, fanout,
                                       out_bf16, summean, s);
    case 4: return launch_int8_mode<4>(table, ids, scale, out, n_table, n_roots, d, fanout,
                                       out_bf16, summean, s);
    case 2: return launch_int8_mode<2>(table, ids, scale, out, n_table, n_roots, d, fanout,
                                       out_bf16, summean, s);
    case 1: return launch_int8_mode<1>(table, ids, scale, out, n_table, n_roots, d, fanout,
                                       out_bf16, summean, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Owner-masked rows: tsg_gather_fanout_mean_owned.
//
// Replaces the owner side of tpu_sage/dist/halo.py::dist_gather_fanout_mean
// (:229-240, XLA in the JAX package): on the partitioned path each rank owns
// the rows [lo, lo + m) of the feature table, and for the deepest level's
// ids of every rank (R*F global ids) it pre-reduces the rows it owns to
// per-root f32 partial means, which the requesters then sum over the ranks:
//   out[r] = fl32(sum_f x[r, f]) * fl32(1/F),
//   x[r, f] = f32(table[ids[r*F + f] - lo]) if lo <= ids[r*F + f] < lo + m,
//             else +0.0,
// summed in f32 in order f = 0, 1, ... from +0.0 (the divisor stays F when
// rows are not owned). That is the jitted reference's form: XLA reduces the
// where-zeroed rows from its zero and multiplies by fl32(1/F)
// (__frcp_rn(F)). An int8 table sums its raw values in int32 (exact, as the
// reference's f32 sum of small integers is) and returns the f32 mean of the
// raw values; the requester applies the scale after the exchange, as the
// reference's dist path does. Bitwise the plain version
// (kernels/gather_mean.py::gather_fanout_mean_owned_reference).
//
// A row the rank does not own is skipped, not added as +0.0: the sum starts
// at +0.0, and in round-to-nearest a sum is -0.0 only when both terms are,
// so the accumulator never holds -0.0 and acc + (+0.0) == acc bitwise.
//
// Bound on the H100: bytes: the owned rows read once and the f32 partial
// means written once (R*d*4 bytes, every root's, owned or not). Rows are
// reused across roots only by reordering the f32 sums (sorting ids, windows
// sized to L2), so the order-keeping floor is every owned id's row read,
// plus the ids and the output. The design is the dense kernel's (one warp
// per root, 4 roots a block, the first F lanes load the root's ids and
// __shfl_sync hands them out, each row read in the widest word that divides
// it, non-coherent loads that skip L1), with the loads in flight counted in
// OWNED rows: the warp ballots which of a 32-id block's ids it owns and
// issues the loads of the next kJ = 5 owned rows, in j order, before adding
// any, so at 4 owners (about 2.5 of a root's 10 ids) a root's rows are one
// batch, not two half-empty ones. When every id of the block is owned (one
// owner, world 1) it takes them kJ at a time directly, with the loads the
// unmasked kernel issues. Realigned 16-byte words (a row read as the
// aligned words that cover it, shifted into place), with the rows held in
// registers or in a per-warp ring of cp.async slots across roots, measured
// slower on the H100 at every shape (PERF.md).

namespace {

template <typename T, int V> struct OwnedWord { using type = typename Word<sizeof(T) * V>::T; };
template <int V> struct OwnedWord<int8_t, V> { using type = typename Int8Word<V>::T; };
template <typename T, int V> struct OwnedWordsPerLane {
  static constexpr int value = WordsPerLane<V>::value;
};
template <int V> struct OwnedWordsPerLane<int8_t, V> {
  static constexpr int value = Int8WordsPerLane<V>::value;
};

template <typename T, int V>
__global__ void __launch_bounds__(kWarps * 32)
gather_fanout_mean_owned_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                                float* __restrict__ out, int64_t lo, int64_t m,
                                int64_t n_roots, int d, int fanout) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  using W = typename OwnedWord<T, V>::type;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int kK = OwnedWordsPerLane<T, V>::value;
  const int lane = threadIdx.x & 31;
  const int64_t root = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (root >= n_roots) return;
  const int32_t* root_ids = ids + root * fanout;
  const int words = d / V;
  float* dst = out + root * d;

  // the row within this rank's range, or -1 for a row it does not own
  auto load_id = [&](int j) -> int64_t {
    if (j >= fanout) return -1;
    const int64_t local = (int64_t)root_ids[j] - lo;
    return (local >= 0 && local < m) ? local : -1;
  };
  const int64_t first_ids = load_id(lane);

#pragma unroll 1
  for (int w0 = 0; w0 < words; w0 += 32 * kK) {
    Acc acc[kK][V];
#pragma unroll
    for (int k = 0; k < kK; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[k][e] = 0;
#pragma unroll 1
    for (int jb = 0; jb < fanout; jb += 32) {
      const int64_t my_id = jb == 0 ? first_ids : load_id(jb + lane);
      const int jend = min(fanout, jb + 32);
      const unsigned in_block = jend - jb == 32 ? 0xffffffffu : (1u << (jend - jb)) - 1u;
      unsigned owned = __ballot_sync(0xffffffffu, my_id >= 0) & in_block;  // warp-uniform
      const bool all = owned == in_block;
#pragma unroll 1
      for (int j0 = jb; owned; j0 += kJ) {
        // the next kJ owned ids, in j order: every id's when all are owned
        int64_t rid[kJ];
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const int j = all ? j0 - jb + jj : (owned ? __ffs(owned) - 1 : 0);
          const int64_t id = __shfl_sync(0xffffffffu, my_id, j & 31);
          rid[jj] = (all ? j0 + jj < jend : owned != 0) ? id : -1;
          owned &= all ? (j0 + jj + 1 < jend ? ~0u : 0u) : owned - 1;
        }
        W v[kJ][kK];
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const W* row = reinterpret_cast<const W*>(table + (rid[jj] < 0 ? 0 : rid[jj]) * d);
#pragma unroll
          for (int k = 0; k < kK; ++k) {
            const int wi = w0 + k * 32 + lane;
            v[jj][k] = W{};
            if (wi < words && rid[jj] >= 0) ld_nc(v[jj][k], row + wi);
          }
        }
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          if (rid[jj] >= 0) {
#pragma unroll
            for (int k = 0; k < kK; ++k)
#pragma unroll
              for (int e = 0; e < V; ++e) {
                if constexpr (kInt8) {
                  acc[k][e] += byte_of(v[jj][k], e);
                } else {
                  acc[k][e] = __fadd_rn(acc[k][e], element<T, V>(v[jj][k], e));
                }
              }
          }
        }
      }
    }
    const float recip = __frcp_rn((float)fanout);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int wi = w0 + k * 32 + lane;
      if (wi < words) {
        float* o = dst + (int64_t)wi * V;
        if constexpr (V == 1) {
          o[0] = __fmul_rn((float)acc[k][0], recip);
        } else {  // V even: d is even, so a word's outputs start 8-byte aligned
#pragma unroll
          for (int e = 0; e < V; e += 2)
            *reinterpret_cast<float2*>(o + e) = make_float2(
                __fmul_rn((float)acc[k][e], recip), __fmul_rn((float)acc[k][e + 1], recip));
        }
      }
    }
  }
}

template <typename T, int V>
int launch_owned(const void* table, const void* ids, void* out, int64_t lo, int64_t m,
                 int64_t n_roots, int d, int fanout, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n_roots + kWarps - 1) / kWarps);
  gather_fanout_mean_owned_kernel<T, V><<<blocks, kWarps * 32, 0, s>>>(
      (const T*)table, (const int32_t*)ids, (float*)out, lo, m, n_roots, d, fanout);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 f32, 1 bf16, 2 int8 table (m, d), this rank's rows [lo, lo + m).
// vec: elements per word, as for tsg_gather_fanout_mean (f32: 2, 1; bf16: 8,
// 4, 2, 1) or bytes per word, as for tsg_gather_fanout_mean_int8 (int8: 16,
// 8, 4, 2, 1). out (n_roots, d) f32, its base 8-byte aligned.
extern "C" int tsg_gather_fanout_mean_owned(const void* table, const void* ids, void* out,
                                            long long lo, long long m, long long n_roots,
                                            int d, int fanout, int kind, int vec,
                                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) {
    switch (vec) {
      case 2: return launch_owned<float, 2>(table, ids, out, lo, m, n_roots, d, fanout, s);
      case 1: return launch_owned<float, 1>(table, ids, out, lo, m, n_roots, d, fanout, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (kind == 1) {
    switch (vec) {
      case 8: return launch_owned<__nv_bfloat16, 8>(table, ids, out, lo, m, n_roots, d, fanout, s);
      case 4: return launch_owned<__nv_bfloat16, 4>(table, ids, out, lo, m, n_roots, d, fanout, s);
      case 2: return launch_owned<__nv_bfloat16, 2>(table, ids, out, lo, m, n_roots, d, fanout, s);
      case 1: return launch_owned<__nv_bfloat16, 1>(table, ids, out, lo, m, n_roots, d, fanout, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (kind == 2) {
    switch (vec) {
      case 16: return launch_owned<int8_t, 16>(table, ids, out, lo, m, n_roots, d, fanout, s);
      case 8: return launch_owned<int8_t, 8>(table, ids, out, lo, m, n_roots, d, fanout, s);
      case 4: return launch_owned<int8_t, 4>(table, ids, out, lo, m, n_roots, d, fanout, s);
      case 2: return launch_owned<int8_t, 2>(table, ids, out, lo, m, n_roots, d, fanout, s);
      case 1: return launch_owned<int8_t, 1>(table, ids, out, lo, m, n_roots, d, fanout, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
