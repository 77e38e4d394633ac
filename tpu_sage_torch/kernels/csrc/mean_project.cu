// Fanout mean + projection, forward:
//   out = to(W.dtype)( to(W.dtype)(mean_f32(x, axis=1)) @ W ),
// the mean summed in f32 in the order j = 0, 1, ..., divided by F and
// rounded once to W's dtype (as jnp.mean of a bf16 tile returns it, or as
// flax's Dense(dtype=bf16) casts the f32 mean of a prep's f32 rows), the
// product accumulated in f32 and rounded once. x is W's dtype, or f32 under
// a bf16 W.
//
// Replaces the forward of tpu_sage/kernels/mean_project.py::mean_project
// (_pallas_forward), the mean aggregator's neighbor branch: x (B, F, D),
// W (D, O). The backward is two matrix products in the reference (outside
// Pallas) and stays two torch.matmul calls in the port.
//
// Bound on the H100: bytes. x must be read once (512 x 25 x 602 bf16 =
// 15.4 MB at layer 0, 512 x 25 x 256 = 6.6 MB at layer 1); W (<= 154 KB)
// and the (B, O) output are small, and the 2*B*D*O operations are far below
// the tensor cores' rate.
//
// bf16 design (bf16 W; x bf16, or f32 rows of a prep's output, which only
// widen the stream's rows and the words the reduction loads). A block owns
// kTB = 4 roots (128 blocks at B = 512, one per SM, 16 warps) and its x
// tile, the contiguous TB*F*D*sizeof(x) bytes of its roots:
//   1. x streams through a ring of kStages = 4 shared-memory slots of G rows
//      of D (about 16 KB: G = 12 at D = 602), three slots in flight. When
//      x's base address and a block's tile length are 16-byte multiples, one
//      thread fills a slot with one bulk asynchronous copy (cp.async.bulk,
//      the TMA engine, completing on an mbarrier per slot); otherwise the
//      threads fill it with cp.async words of 8 or 4 bytes, the widest that
//      divides both (a second code path picked by the caller, not a
//      fallback: a 4-byte-aligned x streams the same way, only narrower).
//   2. W is staged through shared memory in K-chunks of 64 rows with 16-byte
//      cp.async words: chunk c joins the copy group of stream iteration c,
//      so W arrives from L2 while x is still streaming from HBM, and the
//      warps that own no reduction column issue those copies, beside the
//      reduction. W rows are stored unpadded with their 16-byte words
//      permuted by row (word ^ (row & 7)), so the ldmatrix reads below hit
//      distinct banks. When W does not fit beside the x ring, its chunk
//      buffers form a ring refilled during the product.
//   3. Each thread owns column pairs tid + 512*u of a row (bf16x2 or float2
//      words; single columns when D is odd) and reduces the fanout axis in
//      f32 registers as the rows arrive, in the order j = 0, 1, ...; after
//      j = F - 1 it divides by F, rounds to bf16 and stores the (TB, D) mean
//      tile, zero-padded to a multiple of 16 in K, in shared memory.
//   4. The product runs on the tensor cores as out^T = W^T mean^T with
//      mma.sync.m16n8k16 (bf16 in, f32 accumulate): A fragments come from W
//      with ldmatrix.x4.trans, B fragments (N = 8, roots 4..7 zero) from the
//      mean tile. Warp w takes the m-tiles of 16 output columns w % 8 + 8*i
//      over the W chunks of parity w / 8; a chunk's four k-steps load their
//      fragments before their products issue, into two accumulators (even
//      and odd k-steps). The two halves meet in shared memory, and the sum
//      is rounded once to bf16.
// The f32 path stays exact f32 on the SIMT units (no TF32): a block reduces
// four roots' mean into shared memory and its warps accumulate partial
// products over slices of D that are added in a fixed order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

// ---- bf16 path -----------------------------------------------------------

constexpr int kTB = 4;          // roots per block
constexpr int kThreads = 512;   // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;      // x ring slots
constexpr int kKC = 64;         // W rows per chunk
constexpr int kKS = kKC / 16;   // k-steps per chunk
constexpr int kBarBytes = 128;  // the x ring's mbarriers (bulk copies)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int W> __device__ __forceinline__ void cp_async(uint32_t dst, const void* src);
template <> __device__ __forceinline__ void cp_async<16>(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
template <> __device__ __forceinline__ void cp_async<8>(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
}
template <> __device__ __forceinline__ void cp_async<4>(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// One bulk asynchronous copy (the TMA engine, no per-thread requests) of
// `bytes` (a multiple of 16, both addresses 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t* a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Copy `bytes` from global to a ring slot in cp.async words of W bytes; a
// ragged last block's tile may end inside a word, and its tail is copied
// plainly (the barrier before the slot is read orders those stores).
template <int W>
__device__ __forceinline__ void copy_words(unsigned char* slot, const unsigned char* src, int bytes,
                                           int tid) {
  const int nwords = bytes / W;
#pragma unroll 4
  for (int i = tid; i < nwords; i += kThreads) cp_async<W>(smem_u32(slot + i * W), src + i * W);
#pragma unroll 1
  for (int e = nwords * W / 2 + tid; e < bytes / 2; e += kThreads)
    reinterpret_cast<__nv_bfloat16*>(slot)[e] = reinterpret_cast<const __nv_bfloat16*>(src)[e];
}

// W rows sit in shared memory unpadded, o_pad*2 bytes each, with 16-byte
// word `col` of row r stored at word col ^ (r & swz): eight consecutive
// rows' words of one column land in distinct banks for ldmatrix.
__device__ __forceinline__ int w_word(int r, int col, int swz) { return col ^ (r & swz); }

// Issue W rows [c*kKC, c*kKC + rows) into chunk buffer `buf` as 16-byte
// cp.async words, in the caller's open group, from threads t < nthreads. A
// W row is o_pad/8 words (o_pad a power of two, 16..1024): thread t copies
// word t % per_row of rows t / per_row, + nthreads / per_row, ...
__device__ __forceinline__ void issue_w_chunk(const __nv_bfloat16* w, unsigned char* wbufs, int c,
                                              int buf, int d, int o_pad, int t, int nthreads) {
  const int rows = min(kKC, d - c * kKC);
  const int shift = __ffs(o_pad / 8) - 1;  // log2(words per W row)
  const int swz = min(7, (1 << shift) - 1);
  const int col = t & ((1 << shift) - 1);
  const int rstep = nthreads >> shift;  // nthreads is a multiple of the words per row
  const int row_bytes = o_pad * 2;
  unsigned char* dst = wbufs + (size_t)buf * kKC * row_bytes;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(w + (int64_t)c * kKC * o_pad) + col * 16;
#pragma unroll 4
  for (int r = t >> shift; r < rows; r += rstep)
    cp_async<16>(smem_u32(dst + r * row_bytes + w_word(r, col, swz) * 16),
                 src + (int64_t)r * row_bytes);
}

// Load row i's words of this thread (u < NU: word tid + 512*u) as f32; XT is
// x's element type, a word one element or (PAIRS) two.
template <int NU, bool PAIRS, typename XT>
__device__ __forceinline__ void load_row(const unsigned char* slot, int i, int words, int tid,
                                         float* v) {
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int p = tid + u * kThreads;
    if constexpr (sizeof(XT) == 4 && PAIRS) {
      const float2 x2 = p < words ? reinterpret_cast<const float2*>(slot)[i * words + p]
                                  : make_float2(0.f, 0.f);
      v[2 * u] = x2.x;
      v[2 * u + 1] = x2.y;
    } else if constexpr (sizeof(XT) == 4) {
      v[u] = p < words ? reinterpret_cast<const float*>(slot)[i * words + p] : 0.f;
    } else if constexpr (PAIRS) {
      const uint32_t x2 = p < words ? reinterpret_cast<const uint32_t*>(slot)[i * words + p] : 0u;
      v[2 * u] = __uint_as_float(x2 << 16);
      v[2 * u + 1] = __uint_as_float(x2 & 0xffff0000u);
    } else {
      v[u] = p < words ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(slot)[i * words + p])
                       : 0.f;
    }
  }
}

// Add the cnt rows of one ring slot (x rows q0, q0 + 1, ... of the block's
// tile; row q is root q / f, fanout index q % f) into the f32 accumulators
// of this thread's columns, in the order j = 0, 1, ...; after j = f - 1
// store the root's mean, divided by f and rounded to bf16, into the mean
// tile. PAIRS (even d): a thread owns column pairs tid + 512*u of each row;
// otherwise single columns. The rows of one root inside the slot are a run
// with no control flow: four rows' loads are issued before their adds.
template <int NU, bool PAIRS, typename XT>
__device__ __forceinline__ void reduce_slot(const unsigned char* slot, int cnt, int q0, int f,
                                            int d, int k16, __nv_bfloat16* mean, float* acc,
                                            int tid) {
  constexpr int kE = PAIRS ? 2 * NU : NU;  // columns per thread
  const int words = PAIRS ? d / 2 : d;
  int r = q0 / f;
  int j = q0 - r * f;
  int i = 0;
#pragma unroll 1
  while (i < cnt) {
    const int run = min(cnt - i, f - j);  // rows of root r in this slot
    if (j == 0) {
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = 0.f;
    }
    int k = 0;
#pragma unroll 1
    for (; k + 4 <= run; k += 4) {
      float v0[kE], v1[kE], v2[kE], v3[kE];
      load_row<NU, PAIRS, XT>(slot, i + k, words, tid, v0);
      load_row<NU, PAIRS, XT>(slot, i + k + 1, words, tid, v1);
      load_row<NU, PAIRS, XT>(slot, i + k + 2, words, tid, v2);
      load_row<NU, PAIRS, XT>(slot, i + k + 3, words, tid, v3);
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = (((acc[e] + v0[e]) + v1[e]) + v2[e]) + v3[e];
    }
#pragma unroll 1
    for (; k < run; ++k) {
      float v0[kE];
      load_row<NU, PAIRS, XT>(slot, i + k, words, tid, v0);
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] += v0[e];
    }
    i += run;
    j += run;
    if (j == f) {
      const float fd = (float)f;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int p = tid + u * kThreads;
        if (p < words) {
          if constexpr (PAIRS) {
            reinterpret_cast<uint32_t*>(mean + r * k16)[p] =
                pack_bf16x2(acc[2 * u] / fd, acc[2 * u + 1] / fd);
          } else {
            mean[r * k16 + p] = __float2bfloat16(acc[u] / fd);
          }
        }
      }
      j = 0;
      ++r;
    }
  }
}

// MT: m-tiles of 16 output columns per warp (o_pad = 128 * MT, or less when
// MT = 1). NU: reduction words per thread (words <= 512 * NU). XT: x's
// element type (bf16 or f32). x streams with one bulk copy per stage when
// `word` is 16, else with cp.async words of `word` bytes.
template <int MT, int NU, bool PAIRS, typename XT>
__global__ void __launch_bounds__(kThreads, 1)
mean_project_bf16_kernel(const XT* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ out, int64_t b, int f, int d, int o_pad,
                         int word, int g_rows, int n_wbufs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bool bulk = word == 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k16 = (d + 15) & ~15;
  const int nc = (d + kKC - 1) / kKC;
  const int n_res = min(nc, n_wbufs);  // W chunks that have a buffer from the start
  const int row_bytes = o_pad * 2;
  const int swz = min(7, o_pad / 8 - 1);
  constexpr int kXB = sizeof(XT);
  const int slot_bytes = (g_rows * d * kXB + 15) & ~15;
  const uint32_t full0 = smem_u32(smem);  // bulk: slot i's copy completes on full0 + 8*i
  __nv_bfloat16* mean = reinterpret_cast<__nv_bfloat16*>(smem + kBarBytes);  // (kTB, k16)
  float* xbuf = reinterpret_cast<float*>(smem + kBarBytes + kTB * k16 * 2);  // (o_pad/16, 32, 4)
  unsigned char* ring = smem + kBarBytes + kTB * k16 * 2 + o_pad * 32;
  unsigned char* wbufs = ring + (size_t)kStages * slot_bytes;

  const int64_t b0 = (int64_t)blockIdx.x * kTB;
  const int rows = (int)((b - b0) < kTB ? (b - b0) : kTB);
  // zero the mean tile (K padding, roots past a ragged end)
  for (int i = tid; i < kTB * k16 / 2; i += kThreads) reinterpret_cast<uint32_t*>(mean)[i] = 0u;
  if (bulk && tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // 1-2. x stream: stage s holds x rows [s*G, s*G + G) of this block's tile;
  // W chunk s rides in the copy group of iteration s, behind the x stages.
  // The warps that own no reduction column issue W's copies, so those run
  // beside the reduction; when every warp reduces, all of them issue W.
  const int words = PAIRS ? d / 2 : d;
  const int red_warps = NU > 1 ? kWarps : min(kWarps, (words + 31) / 32);
  const int per_row = o_pad / 8;
  const int w_threads = ((kThreads - red_warps * 32) / per_row) * per_row;
  const int w_first = w_threads > 0 ? red_warps * 32 : 0;  // first W-issuing thread
  const int w_count = w_threads > 0 ? w_threads : kThreads;
  const bool w_issuer = tid >= w_first && tid < w_first + w_count;
  const int n_xrows = rows * f;
  const int n_stages = (n_xrows + g_rows - 1) / g_rows;
  const unsigned char* tile = reinterpret_cast<const unsigned char*>(x + b0 * f * d);
  auto issue_stage = [&](int s) {
    unsigned char* slot = ring + (size_t)(s % kStages) * slot_bytes;
    const int bytes = min(g_rows, n_xrows - s * g_rows) * d * kXB;
    const unsigned char* src = tile + (int64_t)s * g_rows * d * kXB;
    if (bulk) {
      if (tid == 0) {
        const uint32_t bar = full0 + 8 * (s % kStages);
        const int bytes16 = bytes & ~15;
        mbar_expect_tx(bar, (uint32_t)bytes16);
        if (bytes16 > 0) bulk_copy(smem_u32(slot), src, (uint32_t)bytes16, bar);
        for (int e = bytes16 / 2; e < bytes / 2; ++e)  // a ragged last block's tail
          reinterpret_cast<__nv_bfloat16*>(slot)[e] =
              reinterpret_cast<const __nv_bfloat16*>(src)[e];
      }
    } else if (word == 8) {
      copy_words<8>(slot, src, bytes, tid);
    } else {
      copy_words<4>(slot, src, bytes, tid);
    }
  };
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) issue_stage(s);
    cp_async_commit();
  }

  // 3. fanout mean in f32 registers, rounded once to bf16 into the tile
  float acc[PAIRS ? 2 * NU : NU];
#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    if (bulk) {
      mbar_wait(full0 + 8 * (s % kStages), (uint32_t)((s / kStages) & 1));
    } else {
      cp_async_wait_ring();
    }
    __syncthreads();
    if (s + kStages - 1 < n_stages) issue_stage(s + kStages - 1);
    if (s < n_res && w_issuer) issue_w_chunk(w, wbufs, s, s, d, o_pad, tid - w_first, w_count);
    cp_async_commit();
    if (warp < red_warps)
      reduce_slot<NU, PAIRS, XT>(ring + (size_t)(s % kStages) * slot_bytes,
                                 min(g_rows, n_xrows - s * g_rows), s * g_rows, f, d, k16, mean,
                                 acc, tid);
  }
#pragma unroll 1
  for (int c = n_stages; c < n_res; ++c) issue_w_chunk(w, wbufs, c, c, d, o_pad, tid, kThreads);
  cp_async_wait_all();
  __syncthreads();

  // 4. out^T = W^T mean^T on the tensor cores. Warp w takes m-tiles
  // w % 8 + 8*mi and the chunks of parity w / 8; a pass covers the W chunks
  // that are resident (one pass on the main path); a chunk's four k-steps
  // load their fragments before their products issue
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 7, kh = warp >> 3;
  const int n_mt = o_pad / 16;
  const int n_ks = k16 / 16;
  const uint32_t* mean32 = reinterpret_cast<const uint32_t*>(mean);
  const int lrow = (lane & 7) + ((lane >> 4) << 3);  // ldmatrix row of this lane
  const int lcol = ((lane >> 3) & 1) * 8;
  float cacc[MT][2][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) cacc[mi][h][e] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < nc; c0 += n_wbufs) {
    const int c1 = min(nc, c0 + n_wbufs);
    if (c0 > 0) {  // W ring: this pass's chunks were issued at the end of the last
      cp_async_wait_all();
      __syncthreads();
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int mt = wm + mi * 8;
      if (mt < n_mt) {
#pragma unroll 1
        for (int c = c0 + kh; c < c1; c += 2) {
          const unsigned char* wb = wbufs + (size_t)(c - c0) * kKC * row_bytes;
          const int col = mt * 2 + (lcol >> 3);  // this lane's 16-byte word of a W row
          const int ks0 = c * kKS;
          uint32_t a[kKS][4], bl[kKS], bh[kKS];
#pragma unroll
          for (int q = 0; q < kKS; ++q) {
            if (ks0 + q < n_ks) {
              int krow = q * 16 + lrow;
              if (c * kKC + krow >= d) krow = d - 1 - c * kKC;  // pad rows: the mean is 0 there
              ldmatrix_x4_trans(
                  smem_u32(wb + (size_t)krow * row_bytes + w_word(krow, col, swz) * 16), a[q]);
              bl[q] = g < kTB ? mean32[g * (k16 / 2) + (ks0 + q) * 8 + t] : 0u;
              bh[q] = g < kTB ? mean32[g * (k16 / 2) + (ks0 + q) * 8 + 4 + t] : 0u;
            }
          }
#pragma unroll
          for (int q = 0; q < kKS; ++q)
            if (ks0 + q < n_ks) mma_bf16(cacc[mi][q & 1], a[q], bl[q], bh[q]);
        }
      }
    }
    if (c1 < nc) {  // W ring: refill the buffers once every warp is done with them
      __syncthreads();
#pragma unroll 1
      for (int c = c1; c < min(nc, c1 + n_wbufs); ++c)
        issue_w_chunk(w, wbufs, c, c - c1, d, o_pad, tid, kThreads);
      cp_async_commit();
    }
  }
  // the odd-chunk warps hand their sums to the even-chunk warps, which add
  // them and round once to bf16
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int mt = wm + mi * 8;
    if (kh == 1 && mt < n_mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xbuf[(mt * 32 + lane) * 4 + e] = cacc[mi][0][e] + cacc[mi][1][e];
  }
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int mt = wm + mi * 8;
    if (kh == 0 && mt < n_mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int root = 2 * t + e;
          const int k = 2 * h + e;
          if (root < rows)
            out[(b0 + root) * o_pad + mt * 16 + g + 8 * h] = __float2bfloat16(
                (cacc[mi][0][k] + cacc[mi][1][k]) + xbuf[(mt * 32 + lane) * 4 + k]);
        }
    }
  }
}

// ---- f32 path ------------------------------------------------------------

constexpr int kF32Warps = 8;  // warps per block
constexpr int kNO = 4;        // output columns per lane per pass (32 * kNO per pass)

__global__ void __launch_bounds__(kF32Warps * 32)
mean_project_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        float* __restrict__ out, int64_t b, int f, int d, int o) {
  extern __shared__ float fsmem[];
  float* mean = fsmem;              // (kTB, d)
  float* part = fsmem + kTB * d;    // (kF32Warps, kTB, o)
  const int64_t b0 = (int64_t)blockIdx.x * kTB;
  const int rows = (int)((b - b0) < kTB ? (b - b0) : kTB);

  // 1. fanout mean of this block's roots, f32, in shared memory
  for (int idx = threadIdx.x; idx < kTB * d; idx += blockDim.x) {
    const int r = idx / d;
    const int c = idx - r * d;
    float acc = 0.f;
    if (r < rows) {
      const float* xp = x + (b0 + r) * (int64_t)f * d + c;
      acc = xp[0];
#pragma unroll 5
      for (int j = 1; j < f; ++j) acc += xp[(int64_t)j * d];
      acc /= (float)f;
    }
    mean[idx] = acc;
  }
  __syncthreads();

  // 2. each warp: partial products over its slice of d
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per = (d + kF32Warps - 1) / kF32Warps;
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
        const float wv = oo < o ? w[(int64_t)c * o + oo] : 0.f;
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
    for (int wp = 0; wp < kF32Warps; ++wp) s += part[(wp * kTB + r) * o + oo];
    out[(b0 + r) * o + oo] = s;
  }
}

template <typename K>
int set_smem(K kernel, size_t smem, size_t* done) {
  if (smem > 48 * 1024 && smem > *done) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    *done = smem;
  }
  return 0;
}

template <int MT, int NU, bool PAIRS, typename XT>
int launch_bf16(const void* x, const void* w, void* out, int64_t b, int f, int d, int o_pad,
                int word, int g_rows, int n_wbufs, size_t smem, cudaStream_t s) {
  static size_t done = 0;
  if (int e = set_smem(mean_project_bf16_kernel<MT, NU, PAIRS, XT>, smem, &done)) return e;
  const unsigned blocks = (unsigned)((b + kTB - 1) / kTB);
  mean_project_bf16_kernel<MT, NU, PAIRS, XT><<<blocks, kThreads, smem, s>>>(
      (const XT*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, b, f, d, o_pad, word,
      g_rows, n_wbufs);
  return (int)cudaGetLastError();
}

template <int MT, typename XT>
int launch_bf16_mt(const void* x, const void* w, void* out, int64_t b, int f, int d, int o_pad,
                   int word, int g_rows, int n_wbufs, size_t smem, cudaStream_t s) {
  const bool pairs = d % 2 == 0;
  const int words = pairs ? d / 2 : d;
#define TSG_LAUNCH(NU, PAIRS) \
  launch_bf16<MT, NU, PAIRS, XT>(x, w, out, b, f, d, o_pad, word, g_rows, n_wbufs, smem, s)
  if (pairs) return words <= kThreads ? TSG_LAUNCH(1, true) : TSG_LAUNCH(2, true);
  if (words <= kThreads) return TSG_LAUNCH(1, false);
  if (words <= 2 * kThreads) return TSG_LAUNCH(2, false);
  return TSG_LAUNCH(4, false);
#undef TSG_LAUNCH
}

}  // namespace

// bf16: x (b, f, d) of x_bytes-byte elements (2: bf16, 4: f32), w (d, o_pad)
// bf16 with o_pad a power of two in [16, 1024] and a 16-byte-aligned base,
// out (b, o_pad) bf16. word_bytes (16, 8 or 4) divides x's base address and
// kTB*f*d*x_bytes; 16 divides g_rows*d*x_bytes. The caller sizes smem_bytes
// as 128 + 4*k16*2 + 32*o_pad + 4*ceil16(g_rows*d*x_bytes) plus
// W's rows, d*o_pad*2 when all are resident (n_wbufs = ceil(d/64)), else
// n_wbufs*64*o_pad*2, within 232,448 (k16 = d rounded up to 16), with
// d <= 2048.
extern "C" int tsg_mean_project_bf16(const void* x, const void* w, void* out, long long b,
                                     int f, int d, int o_pad, int x_bytes, int word_bytes,
                                     int g_rows, int n_wbufs, long long smem_bytes, void* stream) {
  if (word_bytes != 16 && word_bytes != 8 && word_bytes != 4) return (int)cudaErrorInvalidValue;
  if (x_bytes != 2 && x_bytes != 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)smem_bytes;
#define TSG_LAUNCH_X(MT, XT) \
  launch_bf16_mt<MT, XT>(x, w, out, b, f, d, o_pad, word_bytes, g_rows, n_wbufs, smem, s)
#define TSG_LAUNCH(MT) \
  (x_bytes == 4 ? TSG_LAUNCH_X(MT, float) : TSG_LAUNCH_X(MT, __nv_bfloat16))
  if (o_pad <= 128) return TSG_LAUNCH(1);
  if (o_pad <= 256) return TSG_LAUNCH(2);
  if (o_pad <= 512) return TSG_LAUNCH(4);
  return TSG_LAUNCH(8);
#undef TSG_LAUNCH
#undef TSG_LAUNCH_X
}

// f32: shared memory per block 4 * (kTB * d + kF32Warps * kTB * o) bytes; the
// caller keeps it within the 232,448 bytes a Hopper block can have.
extern "C" int tsg_mean_project_f32(const void* x, const void* w, void* out, long long b, int f,
                                    int d, int o, void* stream) {
  static size_t done = 0;
  const size_t smem = ((size_t)kTB * d + (size_t)kF32Warps * kTB * o) * sizeof(float);
  if (int e = set_smem(mean_project_f32_kernel, smem, &done)) return e;
  const unsigned blocks = (unsigned)((b + kTB - 1) / kTB);
  mean_project_f32_kernel<<<blocks, kF32Warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)out, b, f, d, o);
  return (int)cudaGetLastError();
}
