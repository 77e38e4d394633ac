// Column select for the neighbor sampler, and the whole sampler hop fused.
//
// tsg_select_columns: out[b, k] = rows[b, cols[b, k]].
//
// Replaces tpu_sage/kernels/select.py::select_columns_pallas (the one-hot
// compare-select the TPU needs because an element gather is slow there).
// On Hopper an indexed load is the natural form: one thread per (b, k)
// reads cols[b, k] and then the one int32 it names. Rows may be a view with
// a row stride ld >= D (the packed sampler passes the adjacency part of its
// adjacency ‖ degree rows without a copy).
//
// Bound on the H100: bytes. Each output costs one 4-byte load that touches
// one 32-byte sector of rows, so the minimum traffic is the distinct
// sectors the columns hit (~4 MB at the hop-2 shape, rows (12800, 128),
// cols (12800, 10)) plus cols read and out written (~1 MB). The design
// keeps every load independent so many are in flight; consecutive threads
// share a row, so their sectors fall in the same 512-byte row segment.
//
// A column outside [0, D) yields 0, as the one-hot sum does.
//
// tsg_sample_hop: one sampler hop in one launch.
//
// Replaces tpu_sage/kernels/select.py::select_columns_pallas together with
// the hop's two row gathers and its column arithmetic
// (tpu_sage/sample/sampler.py::uniform_neighbor_sample, lines 55-60), which
// the port ran as a degree gather, an adjacency-row gather, six elementwise
// launches and a select. Given the uniforms u (B, K), per (b, k):
//
//   id  = plain(ids[b])     a negative id wraps once by n, then clamps to [0, n)
//   deg = max(degrees[id], 1)                 degree 0 -> column 0, the self pad
//   col = min(trunc(u[b, k] * float(deg)), deg - 1)
//   out[b, k] = (0 <= col < D) ? adj[id, col] : 0
//
// bitwise as the composition computes it: the product is one __fmul_rn
// (never contracted), the float -> int conversion truncates
// (__float2int_rz, as .to(torch.int32) does), deg converts to float with
// __int2float_rn as .to(torch.float32) does.
//
// Bound on the H100: bytes. The hop must read the ids, one 32-byte degree
// sector per distinct id, the distinct 32-byte adjacency sectors its picks
// hit (12.8 of a 512-byte row's 16 at fanout 25, 7.6 at fanout 10 when every
// degree is 128) and u, and write out: about 0.33 MB at hop 1 (B = 512,
// K = 25) and 4.6 MB at hop 2 (B = 12,800, K = 10), 0.0001 and 0.0014 ms at
// 3.35 TB/s. What the old form spent on top, writing the B x 512-byte
// adjacency rows and reading them back (6.5 MB each way at hop 2) and ten
// launches, is gone. The hop is latency-bound by its three dependent loads
// (id -> degree -> adjacency word): one thread per (b, k), so every pick's
// chain is independent and all are in flight together; ids, degrees and adj
// are read through the non-coherent path (__ldg), u and out are coalesced.
// The K threads of a root load the same id and degree word, which the L1
// serves after the first.
//
// Measured on the H100 (PERF.md): 0.0067 ms at hop 1 and 0.0087 ms at hop 2,
// against 0.030 and 0.037 for the gathers, column arithmetic and select it
// replaces, timed in turns. Both are near the floor the three dependent
// loads set: a 512-row degree gather, one dependent load fewer, takes
// 0.0056 ms.
//
// -Xptxas -v (nvcc 12.8, sm_90a): sample_hop_kernel 20 registers,
// select_columns_kernel 16; no spills.

#include <cuda_runtime.h>
#include <cstdint>

__global__ void select_columns_kernel(const int32_t* __restrict__ rows,
                                      const int32_t* __restrict__ cols,
                                      int32_t* __restrict__ out,
                                      int64_t n, int d, int64_t ld, int k) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t b = i / k;
  const int c = cols[i];
  out[i] = (c >= 0 && c < d) ? rows[b * ld + c] : 0;
}

extern "C" int tsg_select_columns(const void* rows, const void* cols, void* out,
                                  long long b, int d, long long ld, int k, void* stream) {
  const int64_t n = (int64_t)b * k;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  select_columns_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)cols, (int32_t*)out, n, d, (int64_t)ld, k);
  return (int)cudaGetLastError();
}

__global__ void sample_hop_kernel(const int32_t* __restrict__ adj,
                                  const int32_t* __restrict__ degrees,
                                  const int32_t* __restrict__ ids,
                                  const float* __restrict__ u,
                                  int32_t* __restrict__ out,
                                  int64_t n_nodes, int d, int64_t total, int k) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float ui = u[i];  // independent of the id chain: issued first
  int64_t id = __ldg(ids + i / k);
  if (id < 0) id += n_nodes;
  id = id < 0 ? 0 : (id >= n_nodes ? n_nodes - 1 : id);
  const int deg = max(__ldg(degrees + id), 1);
  const int c = min(__float2int_rz(__fmul_rn(ui, __int2float_rn(deg))), deg - 1);
  out[i] = (c >= 0 && c < d) ? __ldg(adj + id * d + c) : 0;
}

extern "C" int tsg_sample_hop(const void* adj, const void* degrees, const void* ids,
                              const void* u, void* out, long long n_nodes, int d,
                              long long b, int k, void* stream) {
  const int64_t total = (int64_t)b * k;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  sample_hop_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)adj, (const int32_t*)degrees, (const int32_t*)ids, (const float*)u,
      (int32_t*)out, (int64_t)n_nodes, d, total, k);
  return (int)cudaGetLastError();
}

// tsg_sample_hop_csr: the sampler hop against CSR adjacency.
//
// Replaces tpu_sage/kernels/select.py::select_columns_pallas in the CSR
// hop of the JAX package (tpu_sage/sample/csr.py: the element hop
// uniform_neighbor_sample_csr, whose indices gather the TPU pays per
// element, and the window hop uniform_neighbor_sample_csr_window, which
// fetches the two (window)-wide rows covering a node's span and picks from
// them with the one-hot select). Both forms read the same
// indices[indptr[id] + col]; on Hopper that is one indexed load, so both
// launch this kernel. Per (b, k):
//
//   id  = plain(ids[b])                 as tsg_sample_hop
//   deg = degrees[id], start = indptr[id]          two independent loads
//   deg == 0:  out[b, k] = ids[b]       the self-loop; indices is not read,
//              since start points into the next row's span, or past nnz
//              for a tail node when indices carries no window padding
//   else:      col = min(trunc(u[b, k] * float(max(deg, 1))), deg' - 1)
//              out[b, k] = indices[plain(start + col)]
//
// with tsg_sample_hop's exact operations (__fmul_rn, __float2int_rz,
// __int2float_rn), so the CSR tree is bitwise the dense tree for the same
// uniforms. nnz above 2^31 - 1 is refused on the host (csr_from_padded).
//
// Bound on the H100: bytes. The hop reads the ids, one 32-byte sector of
// degrees and of indptr per distinct id, the 32-byte sectors of indices its
// picks hit (a node's whole span is 4 * deg bytes, so at deg <= 8 one or
// two sectors) and u, and writes out: at hop 2 of the main path (12,800
// ids x 10) about 2.4 MB, 0.0007 ms at 3.35 TB/s. Like tsg_sample_hop it is
// latency-bound by three dependent loads (id -> degree and indptr ->
// indices); one thread per (b, k) keeps every chain independent.

__global__ void sample_hop_csr_kernel(const int32_t* __restrict__ indptr,
                                      const int32_t* __restrict__ indices,
                                      const int32_t* __restrict__ degrees,
                                      const int32_t* __restrict__ ids,
                                      const float* __restrict__ u,
                                      int32_t* __restrict__ out,
                                      int64_t n_nodes, int64_t n_indices, int64_t total,
                                      int k) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float ui = u[i];
  const int32_t raw = __ldg(ids + i / k);
  int64_t id = raw;
  if (id < 0) id += n_nodes;
  id = id < 0 ? 0 : (id >= n_nodes ? n_nodes - 1 : id);
  const int deg = __ldg(degrees + id);
  const int64_t start = __ldg(indptr + id);
  if (deg == 0) {
    out[i] = raw;
    return;
  }
  const int safe = max(deg, 1);
  const int c = min(__float2int_rz(__fmul_rn(ui, __int2float_rn(safe))), safe - 1);
  int64_t pos = start + c;
  if (pos < 0) pos += n_indices;
  pos = pos < 0 ? 0 : (pos >= n_indices ? n_indices - 1 : pos);
  out[i] = __ldg(indices + pos);
}

extern "C" int tsg_sample_hop_csr(const void* indptr, const void* indices, const void* degrees,
                                  const void* ids, const void* u, void* out, long long n_nodes,
                                  long long n_indices, long long b, int k, void* stream) {
  const int64_t total = (int64_t)b * k;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  sample_hop_csr_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)indptr, (const int32_t*)indices, (const int32_t*)degrees,
      (const int32_t*)ids, (const float*)u, (int32_t*)out, (int64_t)n_nodes,
      (int64_t)n_indices, total, k);
  return (int)cudaGetLastError();
}
