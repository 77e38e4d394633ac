// Fanout mean + projection, forward: out = mean(x, axis=1) @ W.
//
// Replaces the forward of tpu_sage/kernels/mean_project.py::mean_project
// (_pallas_forward), the mean aggregator's neighbor branch: x (B, F, D),
// W (D, O), an f32 accumulator, output in x's dtype. The backward is two
// matrix products in the reference (outside Pallas) and stays two
// torch.matmul calls in the port.
//
// Bound on the H100: bytes. x must be read once (512 x 25 x 602 bf16 =
// 15.4 MB at layer 0, 512 x 25 x 256 = 6.6 MB at layer 1); W (<= 154 KB)
// and the (B, O) output are small, and the 2*B*D*O operations are far
// below the card's rate. A block owns TB = 4 roots (128 blocks at B = 512,
// about one per SM):
//   1. its threads reduce the fanout axis of those roots into an f32
//      (TB, D) tile in shared memory, consecutive threads on consecutive
//      columns so x is read in coalesced row segments; the mean never
//      reaches device memory;
//   2. each warp takes a slice of D and each lane up to 4 output columns
//      o (consecutive lanes on consecutive o, so W is read in coalesced
//      rows, once per block); a lane keeps TB x 4 f32 sums in registers,
//      so each W value it loads serves all TB roots;
//   3. the warps' partial sums meet in shared memory and are added in a
//      fixed order, then rounded once to x's dtype.
// Tensor cores (wgmma), TMA and cp.async are for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

constexpr int kTB = 4;       // roots per block
constexpr int kWarps = 8;    // warps per block
constexpr int kNO = 4;       // output columns per lane per pass (32 * kNO per pass)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
mean_project_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                    int64_t b, int f, int d, int o) {
  extern __shared__ float smem[];
  float* mean = smem;              // (kTB, d)
  float* part = smem + kTB * d;    // (kWarps, kTB, o)
  const int64_t b0 = (int64_t)blockIdx.x * kTB;
  const int rows = (int)((b - b0) < kTB ? (b - b0) : kTB);

  // 1. fanout mean of this block's roots, f32, in shared memory
  for (int idx = threadIdx.x; idx < kTB * d; idx += blockDim.x) {
    const int r = idx / d;
    const int c = idx - r * d;
    float acc = 0.f;
    if (r < rows) {
      const T* xp = x + (b0 + r) * (int64_t)f * d + c;
#pragma unroll 5
      for (int j = 0; j < f; ++j) acc += to_float(xp[(int64_t)j * d]);
      acc /= (float)f;
    }
    mean[idx] = acc;
  }
  __syncthreads();

  // 2. each warp: partial products over its slice of d
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per = (d + kWarps - 1) / kWarps;
  const int c_lo = warp * per;
  const int c_hi = min(d, c_lo + per);
  for (int o0 = 0; o0 < o; o0 += 32 * kNO) {
    float acc[kNO][kTB];
#pragma unroll
    for (int k = 0; k < kNO; ++k)
#pragma unroll
      for (int r = 0; r < kTB; ++r) acc[k][r] = 0.f;
    for (int c = c_lo; c < c_hi; ++c) {
      float mv[kTB];
#pragma unroll
      for (int r = 0; r < kTB; ++r) mv[r] = mean[r * d + c];
#pragma unroll
      for (int k = 0; k < kNO; ++k) {
        const int oo = o0 + k * 32 + lane;
        const float wv = oo < o ? to_float(w[(int64_t)c * o + oo]) : 0.f;
#pragma unroll
        for (int r = 0; r < kTB; ++r) acc[k][r] += mv[r] * wv;
      }
    }
#pragma unroll
    for (int k = 0; k < kNO; ++k) {
      const int oo = o0 + k * 32 + lane;
      if (oo < o) {
#pragma unroll
        for (int r = 0; r < kTB; ++r) part[(warp * kTB + r) * o + oo] = acc[k][r];
      }
    }
  }
  __syncthreads();

  // 3. add the warps' partial sums in a fixed order and write
  for (int idx = threadIdx.x; idx < rows * o; idx += blockDim.x) {
    const int r = idx / o;
    const int oo = idx - r * o;
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) s += part[(wp * kTB + r) * o + oo];
    out[(b0 + r) * o + oo] = from_float<T>(s);
  }
}

template <typename T>
static int launch(const void* x, const void* w, void* out, int64_t b, int f, int d, int o,
                  cudaStream_t s) {
  const size_t smem = ((size_t)kTB * d + (size_t)kWarps * kTB * o) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(mean_project_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((b + kTB - 1) / kTB);
  mean_project_kernel<T><<<blocks, kWarps * 32, smem, s>>>((const T*)x, (const T*)w,
                                                           (T*)out, b, f, d, o);
  return (int)cudaGetLastError();
}

// Shared memory per block: 4 * (kTB * d + kWarps * kTB * o) bytes; the
// caller keeps it within the 232,448 bytes a Hopper block can have.
extern "C" int tsg_mean_project(const void* x, const void* w, void* out, long long b,
                                int f, int d, int o, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(x, w, out, b, f, d, o, s)
                 : launch<float>(x, w, out, b, f, d, o, s);
}
