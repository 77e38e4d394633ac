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
#pragma unroll 1
      for (int j0 = jb; j0 < min(fanout, jb + 32); j0 += kJ) {
        W v[kJ][kK];
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const int64_t id = __shfl_sync(0xffffffffu, my_id, j0 - jb + jj);
          const W* row = reinterpret_cast<const W*>(table + id * d);
#pragma unroll
          for (int k = 0; k < kK; ++k) {
            const int wi = w0 + k * 32 + lane;
            if (j0 + jj < fanout && wi < words) ld_nc(v[jj][k], row + wi);
          }
        }
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          if (j0 + jj < fanout) {
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
