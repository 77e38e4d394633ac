// Column select for the neighbor sampler, the whole sampler hop fused, and
// the column pick fused with its hop arithmetic on rows already fetched.
//
// Which path launches which entry point:
//   tsg_sample_hop       the dense sampler's hops (sample/sampler.py::sample_tree,
//                        random_walk): the main path
//   tsg_select_hop       the partitioned hop (dist/train.py::sample_level_distributed,
//                        dense rows and the CSR pair view), the CSR owner-side
//                        pick (dist/halo.py::dist_sample_csr_owner_select) and the
//                        packed sampler (sample/sampler.py::sample_tree_packed)
//   tsg_sample_tree_csr  every CSR tree and walk (sample/csr.py::sample_tree_csr,
//                        train/unsupervised.py::graph_random_walk): all hops of
//                        a tree, up to 4, in one launch
//   tsg_sample_hop_csr   single CSR hops (uniform_neighbor_sample_csr,
//                        CSRNeighborSampler)
//   tsg_select_columns   fixed columns (dist/halo.py::CSRAdjRows.rows) and the
//                        reference's window-pair composition
//                        (sample/csr.py::window_pair_hop)
//
// tsg_select_columns: out[b, k] = rows[b, cols[b, k]].
//
// Replaces tpu_sage/kernels/select.py::select_columns_pallas (the one-hot
// compare-select the TPU needs because an element gather is slow there).
// On Hopper an indexed load is the natural form: one thread per (b, k)
// reads cols[b, k] and then the one int32 it names. Rows may be a view with
// a row stride ld >= D (the adjacency part of adjacency ‖ degree rows,
// without a copy).
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

// tsg_select_hop: the column pick of a hop whose rows are already fetched,
// with the hop's arithmetic fused.
//
// Replaces tpu_sage/kernels/select.py::select_columns_pallas together with
// the column arithmetic around it where a hop's rows come from elsewhere:
// the partitioned hop (tpu_sage/dist/train.py:587-608, rows fetched by halo
// exchange, dense adjacency ‖ degree or the CSR pair view lo ‖ hi ‖ off ‖
// deg), the CSR pick at the owner (tpu_sage/dist/halo.py:135-180) and the
// packed sampler (tpu_sage/sample/sampler.py:111-132). The port ran each as
// clamp_min, five elementwise launches of the column arithmetic, the shift
// add, tsg_select_columns, then == 0 and where: 9-10 launches a hop. Given
// rows (B, D) with row stride ld, a degree per row (pointer and stride: a
// column of the same rows, or a tensor of its own), an optional shift per
// row (the pair view's off), u (B, K) and optional frontier ids, per (b, k):
//
//   deg = max(r_deg[b], 1)
//   col = min(trunc(u[b, k] * float(deg)), deg - 1)
//   col = shift ? shift[b] + col : col                 int32, wrapping as torch's add
//   v   = (0 <= col < D) ? rows[b * ld + col] : 0
//   out[b, k] = (ids && r_deg[b] == 0) ? ids[b] : v    the degree-0 self-loop
//
// with tsg_sample_hop's exact operations (__fmul_rn, __float2int_rz,
// __int2float_rn), so it is bitwise the composition.
//
// Bound on the H100: bytes. The pick reads u, one 32-byte sector per row
// for its degree (and its shift, in the same or the next sector), the
// distinct 32-byte sectors of rows the picks hit and, with ids, 4 bytes a
// row, and writes out: at the partitioned step's hop 2 (25,600 rows of
// stride 129 x 10) about 9 MB, 0.0027 ms at 3.35 TB/s. It is latency-bound
// like the bare select: u, the degree, the shift and the id are issued
// together (none depends on another), then the one dependent pick. One
// thread per (b, k); the K picks of a row sit in adjacent lanes, so its
// degree and shift words reach them from one request. Indices are 32-bit
// when B * K < 2^31, so the division by K is a 32-bit one.
//
// Measured on the H100 (PERF.md): 0.0059-0.0063 ms at the partitioned hop 1
// (1,024 x 25) and 0.0090-0.0093 at hop 2 (25,600 x 10), against 0.032 and
// 0.039 for the nine launches it replaces, timed in turns; the bare select
// took 0.0062 and 0.0088 there. -Xptxas -v (nvcc 12.8, sm_90a):
// select_hop_kernel 16 registers (32-bit indices), 20 (64-bit).

template <typename Index>
__global__ void select_hop_kernel(const int32_t* __restrict__ rows,
                                  const int32_t* __restrict__ deg,
                                  const int32_t* __restrict__ shift,
                                  const int32_t* __restrict__ ids,
                                  const float* __restrict__ u,
                                  int32_t* __restrict__ out,
                                  Index total, int d, int64_t ld, int64_t deg_ld,
                                  int64_t shift_ld, Index k) {
  const Index i = (Index)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float ui = u[i];
  const Index b = i / k;
  const int rdeg = __ldg(deg + (int64_t)b * deg_ld);
  const int s = shift ? __ldg(shift + (int64_t)b * shift_ld) : 0;
  const int self = ids ? __ldg(ids + b) : 0;
  const int dg = max(rdeg, 1);
  const int c = min(__float2int_rz(__fmul_rn(ui, __int2float_rn(dg))), dg - 1);
  const int col = (int)((unsigned)s + (unsigned)c);
  const int v = (col >= 0 && col < d) ? __ldg(rows + (int64_t)b * ld + col) : 0;
  out[i] = (ids && rdeg == 0) ? self : v;
}

extern "C" int tsg_select_hop(const void* rows, const void* deg, const void* shift,
                              const void* ids, const void* u, void* out, long long b, int d,
                              long long ld, long long deg_ld, long long shift_ld, int k,
                              void* stream) {
  const int64_t total = (int64_t)b * k;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (total < ((int64_t)1 << 31)) {
    select_hop_kernel<uint32_t><<<blocks, threads, 0, s>>>(
        (const int32_t*)rows, (const int32_t*)deg, (const int32_t*)shift, (const int32_t*)ids,
        (const float*)u, (int32_t*)out, (uint32_t)total, d, (int64_t)ld, (int64_t)deg_ld,
        (int64_t)shift_ld, (uint32_t)k);
  } else {
    select_hop_kernel<int64_t><<<blocks, threads, 0, s>>>(
        (const int32_t*)rows, (const int32_t*)deg, (const int32_t*)shift, (const int32_t*)ids,
        (const float*)u, (int32_t*)out, total, d, (int64_t)ld, (int64_t)deg_ld,
        (int64_t)shift_ld, (int64_t)k);
  }
  return (int)cudaGetLastError();
}

// tsg_sample_tree_csr: every hop of a CSR tree, or of a CSR walk, in one
// launch.
//
// Replaces tpu_sage/kernels/select.py::select_columns_pallas in the CSR
// trees and walks of the JAX package (tpu_sage/sample/csr.py::
// sample_tree_csr, element and window hops alike, and the CSR walk of
// tpu_sage/train/unsupervised.py::graph_random_walk, a tree of fanout 1 a
// hop of which only the last level is kept), which the port ran as one
// tsg_sample_hop_csr launch a hop, each reading back the level the last
// one wrote. One thread per leaf of the tree walks its ancestry from the
// root with tsg_sample_hop_csr's arithmetic, clamps and degree-0 self-loop
// per hop:
//
//   cur = ids[root]
//   for hop l:  e = the leaf's ancestor at level l + 1
//               id = plain(cur); deg = degrees[id]; start = indptr[id]
//               cur = deg == 0 ? cur
//                     : indices[plain(start + min(trunc(u_l[e] * float(deg)), deg - 1))]
//               level l + 1 [e] = cur, written by e's first leaf only
//
// u_l is hop l's (N_l, f_l) uniforms, so u_l[e] is the pick that made e,
// and the tree is bitwise the hop-by-hop tree for the same uniforms. Up to
// 4 hops a launch (fanouts, uniforms and outputs by value); a deeper tree
// launches again from its last level. A level whose output is null is not
// written (a walk keeps its last). Leaves above 2^31 - 1 are refused on
// the host.
//
// Bound on the H100: bytes. The tree reads its roots, every hop's u, one
// 32-byte sector of degrees and of indptr per distinct frontier id a hop,
// and the distinct sectors of indices the picks hit, and writes every kept
// level once: for the supervised tree (512 roots, fanouts 25, 10) about 1.3
// MB, 0.0004 ms at 3.35 TB/s. It is latency-bound by three dependent loads
// a hop; what the design cuts is the launches and the round trip of each
// level through memory between them. Every leaf's chain is independent and
// all the uniforms are issued before it; siblings sit in adjacent lanes,
// so an ancestor's loads are one request a warp, served once.
//
// Measured on the H100 (PERF.md): the supervised tree 0.0095-0.0099 ms
// against 0.0124 for its two tsg_sample_hop_csr launches, the 3-hop walk
// 0.0103-0.0105 against 0.0151-0.0158, timed in turns: the launch gaps and
// the levels' round trips are gone, the chain of dependent loads (two a
// hop) sets the rest. The NCE tree (6,144 roots) takes what its two hops
// take, 0.032: at 1,536,000 leaves the redone ancestor chains cost what
// the launch saves. One thread per parent of the leaves, its picks issued
// together, was slower at every tree and not kept. -Xptxas -v (nvcc 12.8,
// sm_90a): sample_tree_csr_kernel 14, 18, 22 and 24 registers at 1-4 hops.

struct TreeHops {
  const float* u[4];
  int32_t* out[4];
  unsigned fanout[4];
};

template <int H>
__global__ void sample_tree_csr_kernel(const int32_t* __restrict__ indptr,
                                       const int32_t* __restrict__ indices,
                                       const int32_t* __restrict__ degrees,
                                       const int32_t* __restrict__ ids, TreeHops hops,
                                       int64_t n_nodes, int64_t n_indices, unsigned leaves) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= leaves) return;
  unsigned e[H + 1];  // the leaf's ancestor at each level (e[H] = the leaf)
  bool first[H + 1];  // is this leaf that ancestor's first descendant?
  e[H] = t;
  first[H] = true;
#pragma unroll
  for (int l = H - 1; l >= 0; --l) {
    e[l] = e[l + 1] / hops.fanout[l];
    first[l] = first[l + 1] && e[l + 1] == e[l] * hops.fanout[l];
  }
  float ul[H];
#pragma unroll
  for (int l = 0; l < H; ++l) ul[l] = __ldg(hops.u[l] + e[l + 1]);  // off the id chain
  int32_t cur = __ldg(ids + e[0]);
#pragma unroll
  for (int l = 0; l < H; ++l) {
    int64_t id = cur;
    if (id < 0) id += n_nodes;
    id = id < 0 ? 0 : (id >= n_nodes ? n_nodes - 1 : id);
    const int deg = __ldg(degrees + id);
    const int64_t start = __ldg(indptr + id);
    if (deg != 0) {
      const int safe = max(deg, 1);
      const int c = min(__float2int_rz(__fmul_rn(ul[l], __int2float_rn(safe))), safe - 1);
      int64_t pos = start + c;
      if (pos < 0) pos += n_indices;
      pos = pos < 0 ? 0 : (pos >= n_indices ? n_indices - 1 : pos);
      cur = __ldg(indices + pos);
    }
    if (first[l + 1] && hops.out[l] != nullptr) hops.out[l][e[l + 1]] = cur;
  }
}

extern "C" int tsg_sample_tree_csr(const void* indptr, const void* indices, const void* degrees,
                                   const void* ids, const void* const* u, void* const* out,
                                   const int* fanouts, int n_hops, long long n_nodes,
                                   long long n_indices, long long leaves, void* stream) {
  if (n_hops < 1 || n_hops > 4 || leaves < 0 || leaves > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  TreeHops hops = {};
  for (int l = 0; l < n_hops; ++l) {
    hops.u[l] = (const float*)u[l];
    hops.out[l] = (int32_t*)out[l];
    hops.fanout[l] = (unsigned)fanouts[l];
  }
  const int threads = 256;
  const unsigned blocks = (unsigned)((leaves + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t *p = (const int32_t*)indptr, *x = (const int32_t*)indices,
                *dg = (const int32_t*)degrees, *r = (const int32_t*)ids;
  switch (n_hops) {
    case 1: sample_tree_csr_kernel<1><<<blocks, threads, 0, s>>>(p, x, dg, r, hops, n_nodes,
                                                                 n_indices, (unsigned)leaves);
            break;
    case 2: sample_tree_csr_kernel<2><<<blocks, threads, 0, s>>>(p, x, dg, r, hops, n_nodes,
                                                                 n_indices, (unsigned)leaves);
            break;
    case 3: sample_tree_csr_kernel<3><<<blocks, threads, 0, s>>>(p, x, dg, r, hops, n_nodes,
                                                                 n_indices, (unsigned)leaves);
            break;
    default: sample_tree_csr_kernel<4><<<blocks, threads, 0, s>>>(p, x, dg, r, hops, n_nodes,
                                                                  n_indices, (unsigned)leaves);
  }
  return (int)cudaGetLastError();
}
