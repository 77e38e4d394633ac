// Gather + fanout mean in one pass: out[r] = mean_j table[ids[r*F + j]], f32.
//
// Replaces tpu_sage/kernels/gather_mean.py::gather_fanout_mean, which DMAs
// a root tile's rows into VMEM and reduces them there so the (R*F, d)
// gathered block never reaches HBM. Its Mosaic workarounds (int32 bit view
// of bf16, <=128-lane column chunks, deinterleaved lanes) have no purpose
// on Hopper and are not carried over.
//
// Bound on the H100: bytes. The rows must be read once (128,000 bf16 rows
// of 1,204 bytes at the deepest level of the (25, 10) tree, 154 MB, fewer
// where ids repeat) and the f32 means written once (12,800 x 602 x 4 =
// 30.8 MB). One block owns one root and a tile of 256 columns; its threads
// run across the columns, so each gathered row is read in coalesced
// segments, and loop over the F ids of the root, accumulating in a
// register in f32. The gathered rows live only in registers: nothing but
// the means is written. The sum is divided by F, as jnp.mean does.
//
// Out-of-range ids take the "plain" form of tpu_sage/ops.py: a negative id
// wraps once by n, then the id clamps to [0, n).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void gather_fanout_mean_kernel(const T* __restrict__ table,
                                          const int32_t* __restrict__ ids,
                                          float* __restrict__ out, int64_t n_table,
                                          int d, int fanout) {
  const int64_t r = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= d) return;
  const int32_t* root_ids = ids + r * fanout;
  float acc = 0.f;
#pragma unroll 4
  for (int j = 0; j < fanout; ++j) {
    int64_t id = root_ids[j];
    if (id < 0) id += n_table;
    id = id < 0 ? 0 : (id >= n_table ? n_table - 1 : id);
    acc += to_float(table[id * d + c]);
  }
  out[r * d + c] = acc / (float)fanout;
}

extern "C" int tsg_gather_fanout_mean(const void* table, const void* ids, void* out,
                                      long long n_table, long long n_roots, int d,
                                      int fanout, int is_bf16, void* stream) {
  const int threads = 256;
  const dim3 grid((unsigned)n_roots, (unsigned)((d + threads - 1) / threads));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    gather_fanout_mean_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        (const __nv_bfloat16*)table, (const int32_t*)ids, (float*)out, n_table, d, fanout);
  } else {
    gather_fanout_mean_kernel<float><<<grid, threads, 0, s>>>(
        (const float*)table, (const int32_t*)ids, (float*)out, n_table, d, fanout);
  }
  return (int)cudaGetLastError();
}
