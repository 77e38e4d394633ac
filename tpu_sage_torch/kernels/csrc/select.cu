// Column select for the neighbor sampler: out[b, k] = rows[b, cols[b, k]].
//
// Replaces tpu_sage/kernels/select.py::select_columns_pallas (the one-hot
// compare-select the TPU needs because an element gather is slow there).
// On Hopper an indexed load is the natural form: one thread per (b, k)
// reads cols[b, k] and then the one int32 it names.
//
// Bound on the H100: bytes. Each output costs one 4-byte load that touches
// one 32-byte sector of rows, so the minimum traffic is the distinct
// sectors the columns hit (~4 MB at the hop-2 shape, rows (12800, 128),
// cols (12800, 10)) plus cols read and out written (~1 MB). The design
// keeps every load independent so many are in flight; consecutive threads
// share a row, so their sectors fall in the same 512-byte row segment.
//
// A column outside [0, D) yields 0, as the one-hot sum does.

#include <cuda_runtime.h>
#include <cstdint>

__global__ void select_columns_kernel(const int32_t* __restrict__ rows,
                                      const int32_t* __restrict__ cols,
                                      int32_t* __restrict__ out,
                                      int64_t n, int d, int k) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t b = i / k;
  const int c = cols[i];
  out[i] = (c >= 0 && c < d) ? rows[b * d + c] : 0;
}

extern "C" int tsg_select_columns(const void* rows, const void* cols, void* out,
                                  long long b, int d, int k, void* stream) {
  const int64_t n = (int64_t)b * k;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  select_columns_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)cols, (int32_t*)out, n, d, k);
  return (int)cudaGetLastError();
}
