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
// means 15.4 MB: about 96 MB, 0.029 ms at 3.35 TB/s. The first design read
// a 602-byte row, which is only 2-byte aligned, in 2-byte words, one byte's
// shift, sign extension and add at a time: its loads alone took as long as
// the whole summean kernel, and the work per byte cost time only in the
// dequantize modes (I2F, and F2F for bf16, at a quarter of the integer
// rate) (bench/int8_stages.py; PERF.md). The redesign
// (kernels/gather_mean.py::int8_plan states its choices):
//   - loads: a group of LPR lanes a root (32 for a 602-byte row; 8 or 16 for
//     rows of at most 160 or 320 bytes, several roots a warp); the group's
//     lanes load the root's ids once and __shfl_sync hands them out; each
//     row is read as the aligned 4-byte words that cover it (lane sub of the
//     group takes words sub, sub + LPR, ..., 5 a lane a pass), and the loads
//     of kJ = 5 rows are issued before any is used: 4 bytes in flight a
//     register, twice the first design's. Where a row starts off 4-byte
//     alignment (REALIGN: every row when d or the table's base is not a
//     multiple of 4), column word k (columns 4k .. 4k + 3) is one prmt of
//     span words k and k + 1 with the row's byte offset as its selector,
//     word k + 1 coming from the next lane (one __shfl_sync; the group's
//     first lane supplies the last lane, from the next pass's first word).
//     A word is read only where it holds a byte of its row, so no read
//     leaves the table's 4-byte granules. Ten rows in flight measured no
//     faster (more registers, fewer warps).
//   - summean: each byte biased to q + 128 (one XOR a word), pairs of
//     columns zero-extended into the 16-bit lanes of one register (one prmt
//     a pair) and summed with one 32-bit add: two columns an add, exact
//     while 255 * rows < 2^16, so at most 256 rows (the plan's chunk) before
//     the lanes fold into int32 sums less 128 * rows. Integer sums are exact
//     in any order, so the result is the int32 sum's.
//   - dequantize: no conversion instruction. float(q) is the f32 whose bits
//     are 0x4B000000 | (q + 128) (one prmt of the biased word) minus 8388736
//     (one FADD): exact. bf16: q * scale_bf16 is exact in f32 (8 + 8
//     significant bits) and float(q)'s lower 16 bits are zero, so one
//     mul.rn.bf16x2 of float(q)'s bits by bf16(scale) << 16 rounds the
//     product once into the upper half and leaves +0 in the lower: the bits
//     of the widened bf16 product, added in f32. f32: fma(float(q), scale,
//     acc). The lane's 20 column factors wait in shared memory, read where
//     they are used, and the kernel is held to 102 registers (5 blocks an
//     SM): registers go to loads in flight.
//   - outputs go out in pairs (one at a time for odd d).

namespace {

constexpr int kInt8Chunk = 256;   // rows a packed 16-bit sum holds: 255 * 256 < 2^16
constexpr int kInt8Words = 5;     // 4-byte column words a lane a pass

template <int BYTES> struct Int8Word;
template <> struct Int8Word<1> { using T = uint8_t; };
template <> struct Int8Word<2> { using T = uint16_t; };
template <> struct Int8Word<4> { using T = uint32_t; };
template <> struct Int8Word<8> { using T = uint2; };
template <> struct Int8Word<16> { using T = uint4; };

// the owner-masked kernel's words per lane for V-byte words of an int8 row
template <int V> struct Int8WordsPerLane {
  static constexpr int value = V >= 16 ? 1 : (V == 8 ? 2 : (V == 4 ? 5 : 10));
};

__device__ __forceinline__ void ld_nc(uint8_t& v, const void* p) {
  v = __ldg(reinterpret_cast<const unsigned char*>(p));
}
__device__ __forceinline__ uint32_t part(uint8_t v, int) { return v; }

// byte e of a word, sign-extended
template <typename W>
__device__ __forceinline__ int byte_of(const W& v, int e) {
  return (int)(int8_t)(uint8_t)(part(v, e >> 2) >> (8 * (e & 3)));
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// float(q) of byte e of a word of biased bytes (q ^ 0x80 = q + 128)
__device__ __forceinline__ float magic_float(uint32_t biased, int e) {
  return __fsub_rn(__uint_as_float(prmt(biased, 0x4B000000u, 0x7540u + e)), 8388736.0f);
}

__device__ __forceinline__ float round_out(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 round_out(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}

// two adjacent outputs in one store (4 bytes of bf16, 8 of f32)
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// One column word (4 columns) into its accumulators. summean: acc[0] holds
// columns 0, 1 and acc[1] columns 2, 3 as biased 16-bit sums. dequantize:
// acc[e] is column e's f32 sum, fac[e] its f32 scale (f32 out) or the bits
// bf16(scale) << 16 (bf16 out).
template <int SUMMEAN, bool BF16, typename Acc>
__device__ __forceinline__ void add_word(uint32_t x, Acc (&acc)[4], const float (&fac)[4]) {
  const uint32_t biased = x ^ 0x80808080u;
  if constexpr (SUMMEAN) {
    acc[0] += prmt(biased, 0u, 0x4140u);
    acc[1] += prmt(biased, 0u, 0x4342u);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float qf = magic_float(biased, e);
      if constexpr (BF16) {
        acc[e] = __fadd_rn(acc[e], __uint_as_float(mul_bf16x2(__float_as_uint(qf),
                                                              __float_as_uint(fac[e]))));
      } else {
        acc[e] = __fmaf_rn(qf, fac[e], acc[e]);
      }
    }
  }
}

// a lane's column factors, read back from shared memory where they are used
__device__ __forceinline__ float4 ld_shared(const float4* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return v;
}

// dequantize: at least 5 blocks an SM (at most 102 registers a thread)
template <int SUMMEAN, typename OutT, bool LONG, bool REALIGN>
__global__ void __launch_bounds__(kWarps * 32, SUMMEAN ? 1 : 5)
gather_fanout_mean_int8_kernel(const int8_t* __restrict__ table, const int32_t* __restrict__ ids,
                               const float* __restrict__ scale, OutT* __restrict__ out,
                               int64_t n_table, int64_t n_roots, int d, int fanout,
                               int lanes_per_row, int chunk) {
  using Acc = typename std::conditional<SUMMEAN, uint32_t, float>::type;
  constexpr bool kBf16 = std::is_same<OutT, __nv_bfloat16>::value;
  constexpr int kK = kInt8Words;
  constexpr int kSlots = REALIGN ? kK + 1 : kK;  // the group's first lane loads one more
  const int lane = threadIdx.x & 31;
  const int lpr = lanes_per_row;
  const int sub = lane & (lpr - 1);
  const int64_t warp_root = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / lpr);
  if (warp_root >= n_roots) return;  // whole warps only: the groups shuffle together
  const int64_t root = warp_root + lane / lpr;
  const bool live = root < n_roots;
  const int32_t* root_ids = ids + (live ? root : 0) * fanout;
  const int col_words = (d + 3) >> 2;
  OutT* dst = out + (live ? root : 0) * d;
  const uintptr_t base = reinterpret_cast<uintptr_t>(table);
  // dequantize: each lane's column factors for the pass, 4 a column word
  __shared__ float4 fac_s[SUMMEAN ? 1 : kWarps][kK][32];
  float4(&my_fac)[kK][32] = fac_s[SUMMEAN ? 0 : threadIdx.x >> 5];

  auto load_id = [&](int j) -> int64_t {
    if (j >= fanout) return 0;
    int64_t id = root_ids[j];
    if (id < 0) id += n_table;
    return id < 0 ? 0 : (id >= n_table ? n_table - 1 : id);
  };
  const int64_t first_ids = load_id(sub);  // the group's first lpr ids, loaded once

#pragma unroll 1
  for (int w0 = 0; w0 < col_words; w0 += lpr * kK) {
    Acc acc[kK][4];
    int wide[LONG ? kK : 1][4];  // F > chunk: the folded int32 sums
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int c0 = 4 * (w0 + k * lpr + sub);
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[k][e] = 0;
        if constexpr (LONG) wide[k][e] = 0;
        if constexpr (!SUMMEAN) {
          const float s = c0 + e < d ? scale[c0 + e] : 0.f;
          f[e] = kBf16 ? __uint_as_float(
                             (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(s)) << 16)
                       : s;
        }
      }
      if constexpr (!SUMMEAN) my_fac[k][lane] = make_float4(f[0], f[1], f[2], f[3]);
    }
    int chunk_start = 0;
#pragma unroll 1
    for (int jb = 0; jb < fanout; jb += lpr) {
      const int64_t my_id = jb == 0 ? first_ids : load_id(jb + sub);
      const int jend = min(fanout, jb + lpr);  // the ids the group's lanes hold
#pragma unroll 1
      for (int j0 = jb; j0 < jend; j0 += kJ) {
        uint32_t v[kJ][kSlots];
        uint32_t sel[kJ];  // the realigning prmt's selector: the row's byte offset
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const int64_t id = __shfl_sync(0xffffffffu, my_id, j0 - jb + jj, lpr);
          const uintptr_t a = base + (uintptr_t)(id * d);
          const int sh = REALIGN ? (int)(a & 3) : 0;
          const uint32_t* span = reinterpret_cast<const uint32_t*>(a - sh);
          const int span_words = (sh + d + 3) >> 2;
          sel[jj] = 0x3210u + 0x1111u * (uint32_t)sh;
#pragma unroll
          for (int t = 0; t < kSlots; ++t) {
            const int wi = w0 + t * lpr + sub;
            if (live && j0 + jj < jend && wi < span_words && (t < kK || sub == 0))
              asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];\n"
                           : "=r"(v[jj][t]) : "l"(span + wi));
          }
        }
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          if (j0 + jj < jend) {
#pragma unroll
            for (int k = 0; k < kK; ++k) {
              uint32_t x = v[jj][k];
              if constexpr (REALIGN) {
                const uint32_t next = __shfl_sync(0xffffffffu, sub == 0 ? v[jj][k + 1] : x,
                                                  (sub + 1) & (lpr - 1), lpr);
                x = prmt(x, next, sel[jj]);
              }
              float fac[4] = {};
              if constexpr (!SUMMEAN) {
                const float4 f = ld_shared(&my_fac[k][lane]);
                fac[0] = f.x, fac[1] = f.y, fac[2] = f.z, fac[3] = f.w;
              }
              add_word<SUMMEAN, kBf16>(x, acc[k], fac);
            }
          }
        }
      }
      if constexpr (LONG) {
        if (jb + lpr - chunk_start == chunk || jb + lpr >= fanout) {
          const int bias = 128 * (min(jb + lpr, fanout) - chunk_start);
#pragma unroll
          for (int k = 0; k < kK; ++k) {
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              wide[k][2 * a] += (int)(acc[k][a] & 0xffffu) - bias;
              wide[k][2 * a + 1] += (int)(acc[k][a] >> 16) - bias;
              acc[k][a] = 0;
            }
          }
          chunk_start = jb + lpr;
        }
      }
    }
    const float recip = __frcp_rn((float)fanout);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int c0 = 4 * (w0 + k * lpr + sub);
      if (live && c0 < d) {
        float m[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (SUMMEAN) {
            const int s = LONG ? wide[k][e]
                               : (int)((acc[k][e >> 1] >> (16 * (e & 1))) & 0xffffu) -
                                     128 * fanout;
            m[e] = c0 + e < d ? __fmul_rn((float)s, __fmul_rn(scale[c0 + e], recip)) : 0.f;
          } else {
            m[e] = __fmul_rn(acc[k][e], recip);
          }
        }
        if ((d & 1) == 0) {  // d even: the pairs' outputs start at even elements
#pragma unroll
          for (int e = 0; e < 4; e += 2)
            if (c0 + e < d) store_pair(dst + c0 + e, m[e], m[e + 1]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + e < d) dst[c0 + e] = round_out(m[e], (OutT*)nullptr);
        }
      }
    }
  }
}

template <int SUMMEAN, typename OutT, bool LONG>
int launch_int8(const void* table, const void* ids, const void* scale, void* out,
                int64_t n_table, int64_t n_roots, int d, int fanout, int realign,
                int lanes_per_row, int chunk, cudaStream_t s) {
  const int64_t roots_per_block = (int64_t)kWarps * (32 / lanes_per_row);
  const unsigned blocks = (unsigned)((n_roots + roots_per_block - 1) / roots_per_block);
#define TSG_INT8(RE)                                                                        \
  gather_fanout_mean_int8_kernel<SUMMEAN, OutT, LONG, RE><<<blocks, kWarps * 32, 0, s>>>(   \
      (const int8_t*)table, (const int32_t*)ids, (const float*)scale, (OutT*)out, n_table, \
      n_roots, d, fanout, lanes_per_row, chunk)
  if (realign)
    TSG_INT8(true);
  else
    TSG_INT8(false);
#undef TSG_INT8
  return (int)cudaGetLastError();
}

}  // namespace

// scale: (d,) f32 per-column scales; out (n_roots, d) bf16 (out_bf16 = 1) or
// f32, its base 8-byte aligned. realign, lanes_per_row and chunk are
// kernels/gather_mean.py::int8_plan's: whether rows may start off 4-byte
// alignment (d or the table's base not a multiple of 4), lanes a root (8, 16
// or 32), and, in summean, the rows a packed sum takes before it folds into
// int32 sums (at most 256, and a multiple of lanes_per_row below the
// fanout; the fanout itself in the dequantize modes).
extern "C" int tsg_gather_fanout_mean_int8(const void* table, const void* ids,
                                           const void* scale, void* out, long long n_table,
                                           long long n_roots, int d, int fanout, int out_bf16,
                                           int summean, int realign, int lanes_per_row,
                                           int chunk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((lanes_per_row != 8 && lanes_per_row != 16 && lanes_per_row != 32) || chunk < 1 ||
      (!realign && (d % 4 || reinterpret_cast<uintptr_t>(table) % 4)))
    return (int)cudaErrorInvalidValue;
  const bool long_f = chunk < fanout;
  if (summean ? (chunk > kInt8Chunk || (long_f && chunk % lanes_per_row)) : long_f)
    return (int)cudaErrorInvalidValue;
#define TSG_INT8_MODE(SM, T, L)                                                             \
  return launch_int8<SM, T, L>(table, ids, scale, out, n_table, n_roots, d, fanout, realign, \
                               lanes_per_row, chunk, s)
  if (summean && out_bf16) {
    if (long_f) TSG_INT8_MODE(1, __nv_bfloat16, true);
    TSG_INT8_MODE(1, __nv_bfloat16, false);
  }
  if (summean) {
    if (long_f) TSG_INT8_MODE(1, float, true);
    TSG_INT8_MODE(1, float, false);
  }
  if (out_bf16) TSG_INT8_MODE(0, __nv_bfloat16, false);
  TSG_INT8_MODE(0, float, false);
#undef TSG_INT8_MODE
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
