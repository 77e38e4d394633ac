// The int8 fanout mean taken apart on the card: one set of loads, each
// arithmetic the kernel may do on them, timed alone.
//
// Not a kernel of any path: bench/int8_stages.py builds it and times each
// stage against the others at the int8 step's shape. The loads are those of
// the int8 fanout mean before its redesign (csrc/gather_mean.cu at
// cd99898): one warp a root, 4 roots a block, the row in 2-byte words (a
// 602-byte row is 2-byte aligned), 10 words a lane, the loads of 5 rows
// issued before any is used. STAGE picks what is done with a word's two
// bytes:
//   0  nothing but an XOR into the lane's result (the loads alone);
//   1  shift, sign-extend and add each byte to an int32 sum (the old summean);
//   2  one XOR biasing both bytes to q + 128, one prmt zero-extending them
//      into the two 16-bit lanes of one register and one 32-bit add (the
//      redesigned summean: 128 * F is taken off each lane at the end);
//   3  each byte converted (I2F), multiplied by its bf16 scale, rounded to
//      bf16 (F2F), widened and added in f32 (the old bf16 dequantize);
//   4  each byte through the magic number (prmt into 0x4B0000xx, one FADD),
//      one mul.rn.bf16x2 whose low half is +0, one FADD (the redesigned
//      bf16 dequantize);
//   5  each byte converted (I2F) and fma'd with its f32 scale (the old f32
//      dequantize);
//   6  the magic number and one FFMA (the redesigned f32 dequantize).
// Every stage writes 4 bytes a column, so two stages differ only in their
// arithmetic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kWarps = 4;  // roots per block
constexpr int kJ = 5;      // rows whose loads are in flight together
constexpr int kK = 10;     // 2-byte words per lane per pass

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

__device__ __forceinline__ float magic_to_float(uint32_t biased, int e) {
  return __fsub_rn(__uint_as_float(prmt(biased, 0x4B000000u, 0x7540u + e)), 8388736.0f);
}

template <int STAGE>
__global__ void __launch_bounds__(kWarps * 32)
stage_kernel(const int8_t* __restrict__ table, const int32_t* __restrict__ ids,
             const float* __restrict__ scale, uint32_t* __restrict__ out, int64_t n_table,
             int64_t n_roots, int d, int fanout) {
  const int lane = threadIdx.x & 31;
  const int64_t root = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (root >= n_roots) return;
  const int32_t* root_ids = ids + root * fanout;
  const int words = d / 2;
  auto load_id = [&](int j) -> int64_t {
    if (j >= fanout) return 0;
    int64_t id = root_ids[j];
    if (id < 0) id += n_table;
    return id < 0 ? 0 : (id >= n_table ? n_table - 1 : id);
  };
  const int64_t first_ids = load_id(lane);

#pragma unroll 1
  for (int w0 = 0; w0 < words; w0 += 32 * kK) {
    uint32_t iacc[kK][2] = {};
    float facc[kK][2] = {};
    float sc[kK][2];
    uint32_t scb[kK][2];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int wi = w0 + k * 32 + lane;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float s = wi < words ? scale[wi * 2 + e] : 0.f;
        sc[k][e] = STAGE == 3 ? __bfloat162float(__float2bfloat16_rn(s)) : s;
        scb[k][e] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(s)) << 16;
      }
    }
#pragma unroll 1
    for (int jb = 0; jb < fanout; jb += 32) {
      const int64_t my_id = jb == 0 ? first_ids : load_id(jb + lane);
      const int jend = min(fanout, jb + 32);
#pragma unroll 1
      for (int j0 = jb; j0 < jend; j0 += kJ) {
        uint16_t v[kJ][kK];
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const int64_t id = __shfl_sync(0xffffffffu, my_id, j0 - jb + jj);
          const uint16_t* row = reinterpret_cast<const uint16_t*>(table + id * d);
#pragma unroll
          for (int k = 0; k < kK; ++k) {
            const int wi = w0 + k * 32 + lane;
            if (j0 + jj < jend && wi < words)
              asm volatile("ld.global.nc.L1::no_allocate.b16 %0, [%1];\n"
                           : "=h"(v[jj][k]) : "l"(row + wi));
          }
        }
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          if (j0 + jj < jend) {
#pragma unroll
            for (int k = 0; k < kK; ++k) {
              const uint32_t x = v[jj][k];
              if constexpr (STAGE == 0) {
                iacc[k][0] ^= x;
              } else if constexpr (STAGE == 1) {
                iacc[k][0] += (int)(int8_t)(uint8_t)x;
                iacc[k][1] += (int)(int8_t)(uint8_t)(x >> 8);
              } else if constexpr (STAGE == 2) {
                iacc[k][0] += prmt(x ^ 0x8080u, 0u, 0x4140u);
              } else {
                const uint32_t biased = x ^ 0x8080u;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int q = (int)(int8_t)(uint8_t)(x >> (8 * e));
                  if constexpr (STAGE == 3) {
                    facc[k][e] = __fadd_rn(facc[k][e], __bfloat162float(__float2bfloat16_rn(
                                                          __fmul_rn((float)q, sc[k][e]))));
                  } else if constexpr (STAGE == 4) {
                    facc[k][e] = __fadd_rn(facc[k][e], __uint_as_float(mul_bf16x2(
                        __float_as_uint(magic_to_float(biased, e)), scb[k][e])));
                  } else if constexpr (STAGE == 5) {
                    facc[k][e] = __fmaf_rn((float)q, sc[k][e], facc[k][e]);
                  } else {
                    facc[k][e] = __fmaf_rn(magic_to_float(biased, e), sc[k][e], facc[k][e]);
                  }
                }
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int wi = w0 + k * 32 + lane;
      if (wi < words) {
        uint32_t* o = out + root * d + wi * 2;
        if constexpr (STAGE == 2) {
          o[0] = (uint32_t)((int)(iacc[k][0] & 0xffffu) - 128 * fanout);
          o[1] = (uint32_t)((int)(iacc[k][0] >> 16) - 128 * fanout);
        } else if constexpr (STAGE <= 1) {
          o[0] = iacc[k][0];
          o[1] = iacc[k][1];
        } else {
          o[0] = __float_as_uint(facc[k][0]);
          o[1] = __float_as_uint(facc[k][1]);
        }
      }
    }
  }
}

}  // namespace

// d even and the table's base 2-byte aligned; out (n_roots, d) of 4-byte
// results (int32 for stages 0-2, f32 for 3-6).
extern "C" int tsg_int8_stage(const void* table, const void* ids, const void* scale, void* out,
                              long long n_table, long long n_roots, int d, int fanout,
                              int stage, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((n_roots + kWarps - 1) / kWarps);
#define TSG_STAGE(N)                                                                    \
  stage_kernel<N><<<blocks, kWarps * 32, 0, s>>>((const int8_t*)table, (const int32_t*)ids, \
                                                 (const float*)scale, (uint32_t*)out,   \
                                                 n_table, n_roots, d, fanout)
  switch (stage) {
    case 0: TSG_STAGE(0); break;
    case 1: TSG_STAGE(1); break;
    case 2: TSG_STAGE(2); break;
    case 3: TSG_STAGE(3); break;
    case 4: TSG_STAGE(4); break;
    case 5: TSG_STAGE(5); break;
    case 6: TSG_STAGE(6); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef TSG_STAGE
  return (int)cudaGetLastError();
}
