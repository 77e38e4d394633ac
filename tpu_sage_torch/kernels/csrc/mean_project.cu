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
// 15.4 MB at layer 0, 512 x 25 x 256 = 6.6 MB at layer 1; 341 MB for a
// prep's f32 rows at 12,800 x 10 x 666); W (<= 171 KB) and the (B, O)
// output are small, and the 2*B*D*O operations are far below the tensor
// cores' rate. What sets the rate is the x bytes in flight on each SM, kept
// up without a break from one tile to the next; W (170,496 B at D = 666,
// O = 128) must not be staged from L2 for every 4 roots, as a design of one
// 4-root block per tile did (1.6 times the x it streamed at 12,800 roots).
//
// bf16 design (bf16 W; x bf16, or f32 rows of a prep's output, which only
// widen the stream's rows and the words the reduction loads). Persistent
// blocks of 16 warps: a grid of min(ceil(B / 4), SMs) blocks, each taking
// an even share of the 4-root units (so no block has more than 4 roots
// above another's) and walking it in tiles of TB roots (the plan picks TB:
// 4 while B fits one 4-root unit per SM, as on the main path's B = 512, so
// a block then owns one tile; 16 beyond). A tile's x is the contiguous
// TB*F*D*sizeof(x) bytes of its roots.
//   1. W is staged into shared memory with 16-byte cp.async words, rows
//      stored unpadded with their 16-byte words permuted by row
//      (word ^ (row & 7)) so the ldmatrix reads below hit distinct banks;
//      its chunks of 64 rows ride in the copy groups of the first tile's
//      stages, all issued by its last stage but one, by the warps that own
//      no reduction column. The plan keeps
//      W resident (staged once per block) when it fits beside x slots of at
//      least 16 KB (one tile a block) or 32 KB (several); otherwise its
//      chunks form a ring of buffers refilled during each tile's product, so
//      that x's slots stay large: at 6,144 roots of D = 602 a ring of 5 W
//      chunks beside 38 KB slots beats a resident W beside 19 KB ones.
//   2. x streams through a ring of kStages = 3 shared-memory slots of G
//      rows of D (up to 32 KB at one tile a block, 48 KB at several: the
//      bytes in flight set the stream's rate), two in flight, as one stream
//      across the block's tiles: a tile's stages start in a fresh slot, and
//      the next tile's first
//      stages are in flight while this tile's product and store run. When
//      x's base address and a 4-root unit's length are 16-byte multiples,
//      one thread fills a slot with one bulk asynchronous copy
//      (cp.async.bulk, the TMA engine, completing on an mbarrier per slot);
//      otherwise the threads fill it with cp.async words of 8 or 4 bytes,
//      the widest that divides both (a second code path picked by the
//      caller, not a fallback: a 4-byte-aligned x streams the same way, only
//      narrower). The cursors of both ends advance by increments: no
//      division on the per-stage path.
//   3. Every warp reduces, whatever D: the warps form groups of the fewest
//      warps whose lanes cover a row's column pairs (bf16x2 or float2 words;
//      single columns when D is odd), and group p takes the tile's roots
//      r = p, p + groups, ... (at D = 64, 16 groups of one warp; at D = 602,
//      one group of all 16, 10 of them with columns). Each thread reduces
//      its columns of its group's roots in f32 registers as the rows arrive,
//      in the order j = 0, 1, ... (a root's rows may span two slots: its
//      group carries the sum across), and after j = F - 1 divides by F,
//      rounds to bf16 and stores the root's row of the (TB, D) mean tile,
//      zero-padded to a multiple of 16 in K.
//   4. The product runs on the tensor cores as out^T = W^T mean^T with
//      mma.sync.m16n8k16 (bf16 in, f32 accumulate): A fragments come from W
//      with ldmatrix.x4.trans, B fragments from the mean tile, the roots
//      filling N (8 a fragment; roots 4..7 zero at TB = 4). The work items
//      are (16 output columns, 8 roots) pairs, split in two halves of K (the
//      64-row chunks of each parity) when there are at most 8 pairs, spread
//      over the 16 warps (IPW items a warp). An item's four k-steps load
//      their fragments before their products issue, into two accumulators
//      (even and odd k-steps); the halves of K meet in shared memory, and
//      the sum is rounded once to bf16 and stored.
//
// f32 design (f32 W, f32 x). The product stays exact f32 on the SIMT units
// (TF32 does not meet "highest"); at the main path's shapes it is about 79
// MFLOP, a microsecond of the card's f32 rate, so x's stream sets the time,
// and W (308,224 B at D = 602, O = 128, more than a block's shared memory)
// must be read by every block beside that stream, not after it. Persistent
// blocks of 16 warps: a grid of min(B, SMs) blocks, each taking an even
// share of the roots (no block has more than one root above another's) and
// walking it in tiles of TB roots (a multiple of 4, at most 16: one tile a
// block at B = 512, three at B = 6,144). A tile is cut into column chunks
// of KC = 32 V columns (V = 2: float2 words, when D is even and x 8-byte
// aligned; else V = 1), and the warps split into three roles that run at
// once, chunk by chunk, meeting at mbarriers:
//   1. 11 reducer warps: a warp takes (chunk, root) items in chunk-major
//      order, and each lane copies its V columns of the root's F rows of the
//      chunk into the warp's two shared-memory buffers with cp.async, in
//      batches of FB <= 32 rows, the next batch in flight while it sums this
//      one in f32 registers in the order j = 0, 1, ..., divides by F and
//      stores the mean into a ring of MS chunk slots ((KC, TB), roots
//      contiguous);
//   2. 1 producer thread streams W through a ring of NWB buffers of KW rows
//      with 1-D bulk copies (cp.async.bulk, the TMA engine), so each block
//      reads W once a tile, while x streams;
//   3. 4 product warps: items of (4 roots, 128 output columns), each lane a
//      4 x 4 tile (one broadcast 16-byte read of the 4 roots' means and one
//      16-byte W read a row, 16 fused multiply-adds), accumulate mean . W
//      over the chunks in order as their means and W rows arrive; with
//      fewer items than product warps (B = 512: one item a tile) each item's
//      K is split among ks warps whose partial tiles are added in a fixed
//      order at the tile's end.
// The mean is bitwise the plain version's; the product's order of summation
// is the chunks' and rows' (and the K split's), in f32 with fused
// multiply-adds. Measured on the H100 (PERF.md): with x loaded
// straight into registers the loads went out one row at a time (0.9
// TB/s); a product of one column and 4 roots a lane took longer than the x
// stream; an L2 prefetch of the batch after the next, tiles of 48 roots at
// B = 6,144, and more than 196 KB of shared memory where x paces the tile
// (the L1 keeps the lines of the 8-byte cp.async copies) were slower.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

// ---- bf16 path -----------------------------------------------------------

constexpr int kThreads = 512;   // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;      // x ring slots
constexpr int kKC = 64;         // W rows per chunk
constexpr int kKS = kKC / 16;   // k-steps per chunk
constexpr int kBarBytes = 128;  // the x ring's mbarriers (bulk copies)
constexpr int kMaxSmem = 232448;

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

// The shared-memory layout of the bf16 kernel, from its runtime shape; the
// plan (kernels/mean_project.py::bf16_plan) computes the same numbers.
struct Layout {
  int k16;         // D rounded up to 16 (the product's K)
  int ms;          // mean tile row stride in 32-bit words: 4 mod 32, so the
                   // 8 roots x 4 words of a B fragment hit distinct banks
  int xbuf_bytes;  // the K halves' hand-over: 512 B per (columns, roots) pair
  int ring_off;    // the x ring's offset, and each slot's bytes: 128-byte multiples
  int slot_bytes;
  size_t w_bytes;  // W's buffers, after the ring
  size_t total;
  __host__ __device__ Layout(int d, int o_pad, int xb, int g_rows, int n_wbufs, int tb,
                             int ksplit) {
    k16 = (d + 15) & ~15;
    ms = (((k16 / 2) + 31) & ~31) + 4;
    xbuf_bytes = ksplit == 2 ? (o_pad / 16) * ((tb + 7) / 8) * 512 : 0;
    ring_off = (kBarBytes + tb * ms * 4 + xbuf_bytes + 127) & ~127;
    slot_bytes = (g_rows * d * xb + 127) & ~127;
    const int nc = (d + kKC - 1) / kKC;
    w_bytes = n_wbufs >= nc ? (size_t)d * o_pad * 2 : (size_t)n_wbufs * kKC * o_pad * 2;
    total = (size_t)ring_off + (size_t)kStages * slot_bytes + w_bytes;
  }
};

// Copy `bytes` from global to a ring slot in cp.async words of W bytes; a
// ragged last tile may end inside a word, and its tail is copied plainly
// (the barrier before the slot is read orders those stores).
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
// cp.async words, in the caller's open group, from threads t < nthreads (a
// multiple of the words per row). A W row is o_pad/8 words (o_pad a power of
// two, 16..1024): thread t copies word t % per_row of rows t / per_row,
// + nthreads / per_row, ...
__device__ __forceinline__ void issue_w_chunk(const __nv_bfloat16* w, unsigned char* wbufs, int c,
                                              int buf, int d, int o_pad, int t, int nthreads) {
  const int rows = min(kKC, d - c * kKC);
  const int shift = __ffs(o_pad / 8) - 1;  // log2(words per W row)
  const int swz = min(7, (1 << shift) - 1);
  const int col = t & ((1 << shift) - 1);
  const int rstep = nthreads >> shift;
  const int row_bytes = o_pad * 2;
  unsigned char* dst = wbufs + (size_t)buf * kKC * row_bytes;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(w + (int64_t)c * kKC * o_pad) + col * 16;
#pragma unroll 4
  for (int r = t >> shift; r < rows; r += rstep)
    cp_async<16>(smem_u32(dst + r * row_bytes + w_word(r, col, swz) * 16),
                 src + (int64_t)r * row_bytes);
}

// Load row i's words of this thread (u < NU: word p0 + gsize*u) as f32; XT
// is x's element type, a word one element or (PAIRS) two.
template <int NU, bool PAIRS, typename XT>
__device__ __forceinline__ void load_row(const unsigned char* slot, int i, int words, int p0,
                                         int gsize, float* v) {
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int p = p0 + u * gsize;
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

// Add the rows of one ring slot (rows q0 .. q0 + cnt - 1 of the tile; row q
// is root q / f, fanout index q % f) that belong to this thread's group's
// roots (r = grp, grp + n_groups, ...) into the f32 accumulators of its
// columns, in the order j = 0, 1, ...; after j = f - 1 store the root's
// mean, divided by f and rounded to bf16, into the mean tile (row stride ms
// words). A group has at most one root open at a slot's end (the last root
// of the slot), whose sum it carries into the next slot. PAIRS (even d): a
// thread owns column pairs p0 + gsize*u of each row; otherwise single
// columns. A root's rows in the slot are a run with no control flow: four
// rows' loads are issued before their adds.
template <int NU, bool PAIRS, typename XT>
__device__ __forceinline__ void reduce_slot(const unsigned char* slot, int cnt, int q0, int f,
                                            int d, int ms, uint32_t* mean32, float* acc, int p0,
                                            int gsize, int grp, int n_groups) {
  constexpr int kE = PAIRS ? 2 * NU : NU;  // columns per thread
  const int words = PAIRS ? d / 2 : d;
  const int q1 = q0 + cnt;
  int r = q0 / f;
  if (n_groups > 1) r += (grp - r % n_groups + n_groups) % n_groups;  // the group's first root
#pragma unroll 1
  for (; r * f < q1; r += n_groups) {
    const int lo = max(q0, r * f), hi = min(q1, r * f + f);
    if (lo == r * f) {
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = 0.f;
    }
    int i = lo - q0;
    const int iend = hi - q0;
#pragma unroll 1
    for (; i + 4 <= iend; i += 4) {
      float v0[kE], v1[kE], v2[kE], v3[kE];
      load_row<NU, PAIRS, XT>(slot, i, words, p0, gsize, v0);
      load_row<NU, PAIRS, XT>(slot, i + 1, words, p0, gsize, v1);
      load_row<NU, PAIRS, XT>(slot, i + 2, words, p0, gsize, v2);
      load_row<NU, PAIRS, XT>(slot, i + 3, words, p0, gsize, v3);
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = (((acc[e] + v0[e]) + v1[e]) + v2[e]) + v3[e];
    }
#pragma unroll 1
    for (; i < iend; ++i) {
      float v0[kE];
      load_row<NU, PAIRS, XT>(slot, i, words, p0, gsize, v0);
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] += v0[e];
    }
    if (hi == r * f + f) {
      const float fd = (float)f;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int p = p0 + u * gsize;
        if (p < words) {
          if constexpr (PAIRS) {
            mean32[r * ms + p] = pack_bf16x2(acc[2 * u] / fd, acc[2 * u + 1] / fd);
          } else {
            reinterpret_cast<__nv_bfloat16*>(mean32)[r * 2 * ms + p] = __float2bfloat16(acc[u] / fd);
          }
        }
      }
    }
  }
}

// One tile's product out[root0 + n, :] = mean[n, :] @ W for n < roots, on
// the tensor cores (see 4. above). IPW: work items per warp. Runs W's ring
// passes when W is not resident, and then (refill) issues the ring's first
// chunks for the block's next tile.
template <int IPW>
__device__ __forceinline__ void project_tile(const uint32_t* mean32, unsigned char* wbufs,
                                             float* xbuf, const __nv_bfloat16* w,
                                             __nv_bfloat16* out, int64_t root0, int roots,
                                             int tb, int d, int o_pad, int ms, int n_wbufs,
                                             int ksplit, bool refill) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_mt = o_pad / 16, n_nt = (tb + 7) / 8;
  const int n_items = n_mt * n_nt * ksplit;
  const int n_ks = ((d + 15) & ~15) / 16;
  const int nc = (d + kKC - 1) / kKC;
  const int row_bytes = o_pad * 2;
  const int swz = min(7, o_pad / 8 - 1);
  const int lrow = (lane & 7) + ((lane >> 4) << 3);  // ldmatrix row of this lane
  const int lcol = ((lane >> 3) & 1) * 8;
  float cacc[IPW][2][4];
#pragma unroll
  for (int ii = 0; ii < IPW; ++ii)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) cacc[ii][h][e] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < nc; c0 += n_wbufs) {
    const int c1 = min(nc, c0 + n_wbufs);
    if (c0 > 0) {  // W ring: this pass's chunks were issued at the end of the last
      cp_async_wait_all();
      __syncthreads();
    }
#pragma unroll
    for (int ii = 0; ii < IPW; ++ii) {
      const int item = warp + kWarps * ii;
      if (item < n_items) {
        const int kh = item % ksplit, rest = item / ksplit;
        const int mt = rest % n_mt, nt = rest / n_mt;
        const int col = mt * 2 + (lcol >> 3);  // this lane's 16-byte word of a W row
        const int nroot = nt * 8 + g;          // this lane's root of the B fragment
        const bool live = nroot < tb;
        const uint32_t* mrow = mean32 + (live ? nroot : 0) * ms;
#pragma unroll 1
        for (int c = c0 + kh; c < c1; c += ksplit) {
          const unsigned char* wb = wbufs + (size_t)(c - c0) * kKC * row_bytes;
          const int ks0 = c * kKS;
          uint32_t a[kKS][4], bl[kKS], bh[kKS];
#pragma unroll
          for (int q = 0; q < kKS; ++q) {
            if (ks0 + q < n_ks) {
              int krow = q * 16 + lrow;
              if (c * kKC + krow >= d) krow = d - 1 - c * kKC;  // pad rows: the mean is 0 there
              ldmatrix_x4_trans(
                  smem_u32(wb + (size_t)krow * row_bytes + w_word(krow, col, swz) * 16), a[q]);
              bl[q] = live ? mrow[(ks0 + q) * 8 + t] : 0u;
              bh[q] = live ? mrow[(ks0 + q) * 8 + 4 + t] : 0u;
            }
          }
#pragma unroll
          for (int q = 0; q < kKS; ++q)
            if (ks0 + q < n_ks) mma_bf16(cacc[ii][q & 1], a[q], bl[q], bh[q]);
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
  if (nc > n_wbufs && refill) {  // W ring: the next tile's first chunks
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < n_wbufs; ++c) issue_w_chunk(w, wbufs, c, c, d, o_pad, tid, kThreads);
    cp_async_commit();
  }
  // the second half of K hands its sums to the first, which adds them and
  // rounds once to bf16
  if (ksplit == 2) {
#pragma unroll
    for (int ii = 0; ii < IPW; ++ii) {
      const int item = warp + kWarps * ii;
      if (item < n_items && item % 2 == 1)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xbuf[((item / 2) * 32 + lane) * 4 + e] = cacc[ii][0][e] + cacc[ii][1][e];
    }
    __syncthreads();
  }
#pragma unroll
  for (int ii = 0; ii < IPW; ++ii) {
    const int item = warp + kWarps * ii;
    if (item < n_items && item % ksplit == 0) {
      const int rest = item / ksplit;
      const int mt = rest % n_mt, nt = rest / n_mt;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int root = nt * 8 + 2 * t + e;
          const int k = 2 * h + e;
          if (root < roots) {
            float v = cacc[ii][0][k] + cacc[ii][1][k];
            if (ksplit == 2) v += xbuf[(rest * 32 + lane) * 4 + k];
            out[(root0 + root) * o_pad + mt * 16 + g + 8 * h] = __float2bfloat16(v);
          }
        }
    }
  }
}

// IPW: product items per warp. NU: reduction words per thread (words <=
// 32 * group warps * NU). XT: x's element type (bf16 or f32). x streams with
// one bulk copy per stage when `word` is 16, else with cp.async words of
// `word` bytes.
template <int IPW, int NU, bool PAIRS, typename XT>
__global__ void __launch_bounds__(kThreads, 1)
mean_project_bf16_kernel(const XT* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ out, int64_t b, int f, int d, int o_pad,
                         int word, int g_rows, int n_wbufs, int tb, int ksplit) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kXB = sizeof(XT);
  const Layout lay(d, o_pad, kXB, g_rows, n_wbufs, tb, ksplit);
  const bool bulk = word == 16;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int nc = (d + kKC - 1) / kKC;
  const int n_res = min(nc, n_wbufs);  // W chunks that have a buffer from the start
  const bool resident = n_wbufs >= nc;
  const int64_t xrow = (int64_t)d * kXB;
  const uint32_t full0 = smem_u32(smem);  // bulk: slot i's copy completes on full0 + 8*i
  uint32_t* mean32 = reinterpret_cast<uint32_t*>(smem + kBarBytes);  // (tb, ms) words
  float* xbuf = reinterpret_cast<float*>(smem + kBarBytes + (size_t)tb * lay.ms * 4);
  unsigned char* ring = smem + lay.ring_off;
  unsigned char* wbufs = ring + (size_t)kStages * lay.slot_bytes;

  // the block's roots: an even share of the 4-root units, [r_begin, r_end),
  // walked in tiles of tb roots (tile k from r_begin + k * tb); a tile of
  // `roots` roots streams in ceil(roots * f / g_rows) stages
  const int units = (int)((b + 3) / 4), bx = blockIdx.x;
  const int per = units / gridDim.x, extra = units - per * gridDim.x;
  const int64_t r_begin = 4 * (int64_t)(bx * per + min(bx, extra));
  const int64_t r_cut = r_begin + 4 * (per + (bx < extra ? 1 : 0));
  const int64_t r_end = r_cut < b ? r_cut : b;
  const int my_tiles = ((int)(r_end - r_begin) + tb - 1) / tb;
  auto roots_of = [&](int64_t root0) { return (int)(r_end - root0 < tb ? r_end - root0 : tb); };
  auto stages_of = [&](int roots) { return (roots * f + g_rows - 1) / g_rows; };

  // zero the mean tile once (K padding; the roots past a ragged end are
  // never stored)
  for (int i = tid; i < tb * lay.ms; i += kThreads) mean32[i] = 0u;
  if (bulk && tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the reduction groups; the warps that own no reduction column issue W's
  // copies, so those run beside the reduction (when every warp reduces, all
  // of them issue W)
  const int words = PAIRS ? d / 2 : d;
  int gw = kWarps;  // warps per group
  if (NU == 1)
    while (gw > 1 && (gw / 2) * 32 >= words) gw /= 2;
  const int grp = warp / gw, n_groups = kWarps / gw;
  const int gsize = gw * 32, p0 = tid - grp * gsize;
  const bool reducer = (p0 & ~31) < words;
  const int red_warps = gw < kWarps || NU > 1 ? kWarps : min(kWarps, (words + 31) / 32);
  const int per_row = o_pad / 8;
  const int w_threads = ((kThreads - red_warps * 32) / per_row) * per_row;
  const int w_first = w_threads > 0 ? red_warps * 32 : 0;  // first W-issuing thread
  const int w_count = w_threads > 0 ? w_threads : kThreads;
  const bool w_issuer = tid >= w_first && tid < w_first + w_count;

  // 2. the x stream, one ring across the block's tiles: the producer's
  // cursor (tile p_k, its stage p_ls, ring slot p_slot) runs kStages - 1
  // ahead of the consumer's
  int p_k = 0, p_ls = 0, p_slot = 0;
  int64_t p_tile = r_begin;  // the tile's first root
  int p_roots = roots_of(p_tile), p_stages = stages_of(p_roots);
  auto issue_next = [&]() {
    if (p_k < my_tiles) {
      unsigned char* slot = ring + (size_t)p_slot * lay.slot_bytes;
      const int bytes = (int)(min(g_rows, p_roots * f - p_ls * g_rows) * xrow);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(x) +
                                 (p_tile * f + (int64_t)p_ls * g_rows) * xrow;
      if (bulk) {
        if (tid == 0) {
          const uint32_t bar = full0 + 8 * (uint32_t)p_slot;
          const int bytes16 = bytes & ~15;
          mbar_expect_tx(bar, (uint32_t)bytes16);
          if (bytes16 > 0) bulk_copy(smem_u32(slot), src, (uint32_t)bytes16, bar);
          for (int e = bytes16 / 2; e < bytes / 2; ++e)  // the ragged end of x
            reinterpret_cast<__nv_bfloat16*>(slot)[e] =
                reinterpret_cast<const __nv_bfloat16*>(src)[e];
        }
      } else if (word == 8) {
        copy_words<8>(slot, src, bytes, tid);
      } else {
        copy_words<4>(slot, src, bytes, tid);
      }
      if (++p_ls == p_stages) {
        p_ls = 0;
        if (++p_k < my_tiles) {
          p_tile += tb;
          p_roots = roots_of(p_tile);
          p_stages = stages_of(p_roots);
        }
      }
      p_slot = p_slot + 1 == kStages ? 0 : p_slot + 1;
    }
  };
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    issue_next();
    cp_async_commit();
  }

  // 1 and 3: W's chunks ride in the copy groups of the first tile's stages;
  // the fanout mean in f32 registers, rounded once to bf16 into the tile
  float acc[PAIRS ? 2 * NU : NU];
  int c_k = 0, c_ls = 0, c_slot = 0, sg = 0;
  uint32_t c_phase = 0;
  int64_t c_tile = r_begin;
  int c_roots = roots_of(c_tile), c_stages = stages_of(c_roots);
  // W chunks issued per stage: all of them by the first tile's last stage but one
  const int w_per = (n_res + max(1, c_stages - 1) - 1) / max(1, c_stages - 1);
#pragma unroll 1
  while (c_k < my_tiles) {
    if (bulk) {
      mbar_wait(full0 + 8 * (uint32_t)c_slot, c_phase);
    } else {
      cp_async_wait_ring();
    }
    __syncthreads();
    if (c_k == 0 && w_issuer)
#pragma unroll 1
      for (int c = sg * w_per; c < min(n_res, (sg + 1) * w_per); ++c)
        issue_w_chunk(w, wbufs, c, c, d, o_pad, tid - w_first, w_count);
    issue_next();
    cp_async_commit();
    if (reducer)
      reduce_slot<NU, PAIRS, XT>(ring + (size_t)c_slot * lay.slot_bytes,
                                 min(g_rows, c_roots * f - c_ls * g_rows), c_ls * g_rows, f, d,
                                 lay.ms, mean32, acc, p0, gsize, grp, n_groups);
    if (c_ls == c_stages - 1) {  // the tile's mean is complete: 4. its product
      if (c_k == 0) {
#pragma unroll 1
        for (int c = (sg + 1) * w_per; c < n_res; ++c)
          issue_w_chunk(w, wbufs, c, c, d, o_pad, tid, kThreads);
        cp_async_commit();
      }
      if (c_k == 0 || !resident) cp_async_wait_all();
      __syncthreads();
      project_tile<IPW>(mean32, wbufs, xbuf, w, out, c_tile, c_roots, tb, d, o_pad, lay.ms,
                        n_wbufs, ksplit, c_k + 1 < my_tiles);
      __syncthreads();
      c_ls = 0;
      if (++c_k < my_tiles) {
        c_tile += tb;
        c_roots = roots_of(c_tile);
        c_stages = stages_of(c_roots);
      }
    } else {
      ++c_ls;
    }
    if (++c_slot == kStages) {
      c_slot = 0;
      c_phase ^= 1u;
    }
    ++sg;
  }
}

// ---- f32 path ------------------------------------------------------------

constexpr int kF32Warps = 16;                           // 512 threads
constexpr int kProdWarps = 4;                           // warps 1 .. 4
constexpr int kRedWarps = kF32Warps - 1 - kProdWarps;   // warps 5 .. 15
constexpr int kF32BarBytes = 512;
constexpr int kRedBytes = kProdWarps * 32 * 16 * 4;     // the K split's partial tiles

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void product_sync() {  // the 4 product warps only
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProdWarps * 32) : "memory");
}

template <int V> struct FWord;
template <> struct FWord<1> { using T = float; };
template <> struct FWord<2> { using T = float2; };
__device__ __forceinline__ float comp(float v, int) { return v; }
__device__ __forceinline__ float comp(float2 v, int e) { return e == 0 ? v.x : v.y; }

// The shared-memory layout of the f32 kernel: the rings' mbarriers, two x
// buffers of FB rows of a chunk for each reducer warp, MS mean slots of (KC,
// TB) f32, NWB W buffers of (KW, O_pad) f32, and the K split's partial
// tiles when K is split; the plan (kernels/mean_project.py::f32_plan)
// computes the same numbers.
struct F32Layout {
  size_t xbuf_off, mean_off, w_off, red_off, total;
  __host__ __device__ F32Layout(int kc, int fb, int tb, int ms, int kw, int o_pad, int nwb,
                                int ks) {
    xbuf_off = kF32BarBytes;
    mean_off = xbuf_off + (size_t)kRedWarps * 2 * fb * kc * 4;
    w_off = mean_off + (size_t)ms * tb * kc * 4;
    red_off = w_off + (size_t)nwb * kw * o_pad * 4;
    total = red_off + (ks > 1 ? kRedBytes : 0);
  }
};

// The product's work: items of (4 roots, 128 output columns), each lane a
// 4 x 4 tile of them; when there are fewer items than product warps, each
// item's K is split among ks = kProdWarps / items warps (rows k = kpart mod
// ks), whose partial tiles meet in shared memory in a fixed order.
__host__ __device__ inline int f32_ks(int tb, int o_pad) {
  const int items = (tb / 4) * ((o_pad + 127) / 128);
  return items >= kProdWarps ? 1 : kProdWarps / items;
}

// V: elements of an x word (2: float2, 1: float). NI: product items a
// product warp. x (b, f, d) f32; w (d, o_pad) f32 with a 16-byte-aligned
// base; out (b, o) f32.
template <int V, int NI>
__global__ void __launch_bounds__(kF32Warps * 32, 1)
mean_project_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        float* __restrict__ out, int64_t b, int f, int d, int o, int o_pad,
                        int fb, int tb, int ms, int kw, int nwb) {
  using XW = typename FWord<V>::T;
  constexpr int kKC = 32 * V;  // columns of a chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const int ks = f32_ks(tb, o_pad);
  const F32Layout lay(kKC, fb, tb, ms, kw, o_pad, nwb, ks);
  const uint32_t full_m = smem_u32(smem);  // barrier i of each kind at + 8 i
  const uint32_t empty_m = full_m + 8 * ms;
  const uint32_t full_w = empty_m + 8 * ms;
  const uint32_t empty_w = full_w + 8 * nwb;
  float* mring = reinterpret_cast<float*>(smem + lay.mean_off);
  float* wring = reinterpret_cast<float*>(smem + lay.w_off);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the block's roots: an even share, [r_begin, r_end), in tiles of tb
  const int64_t bx = blockIdx.x;
  const int64_t per = b / gridDim.x, extra = b - per * gridDim.x;
  const int64_t r_begin = bx * per + (bx < extra ? bx : extra);
  const int64_t r_end = r_begin + per + (bx < extra ? 1 : 0);
  const int tiles = (int)((r_end - r_begin + tb - 1) / tb);
  const int nch = (d + kKC - 1) / kKC;
  auto chunk_cols = [&](int c) { return min(kKC, d - c * kKC); };

  if (tid == 0) {
    for (int i = 0; i < ms; ++i) {
      mbar_init(full_m + 8 * i, tb * 32);           // every reducer lane of a chunk's tb items
      mbar_init(empty_m + 8 * i, kProdWarps * 32);  // every product lane
    }
    for (int i = 0; i < nwb; ++i) {
      mbar_init(full_w + 8 * i, 1);                 // the producer's expect_tx
      mbar_init(empty_w + 8 * i, kProdWarps * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // 2. the producer: W's blocks of kw rows, for each tile and chunk in order
    if (lane == 0) {
      int s = 0;
#pragma unroll 1
      for (int t = 0; t < tiles; ++t)
#pragma unroll 1
        for (int c = 0; c < nch; ++c) {
          const int kc = chunk_cols(c);
#pragma unroll 1
          for (int k0 = 0; k0 < kc; k0 += kw, ++s) {
            const int slot = s % nwb, use = s / nwb;
            if (use > 0) mbar_wait(empty_w + 8 * slot, (use - 1) & 1);
            const uint32_t bytes = (uint32_t)(min(kw, kc - k0) * o_pad * 4);
            mbar_expect_tx(full_w + 8 * slot, bytes);
            bulk_copy(smem_u32(wring + (size_t)slot * kw * o_pad),
                      w + (int64_t)(c * kKC + k0) * o_pad, bytes, full_w + 8 * slot);
          }
        }
    }
    return;
  }

  if (warp > kProdWarps) {
    // 1. the reducers: item i = (tile t, chunk c, root r), chunk-major, in
    // batches of fb rows. A lane copies its V columns of a batch's rows into
    // the warp's buffer with cp.async while it sums the previous batch, and
    // reads back only what it copied. A ragged tile's missing roots still
    // arrive, so a chunk always counts tb
    const int rw = warp - 1 - kProdWarps;
    const int per_tile = nch * tb, n_items = tiles * per_tile;
    const int nb = (f + fb - 1) / fb;  // batches of an item
    XW* xb = reinterpret_cast<XW*>(smem + lay.xbuf_off) + (size_t)rw * 2 * fb * 32;
    const float fd = (float)f;
    const int col = lane * V;
    auto decode = [&](int i, int64_t& root, int& c, int& r) {
      const int t = i / per_tile, rem = i - t * per_tile;
      c = rem / tb;
      r = rem - c * tb;
      root = r_begin + (int64_t)t * tb + r;
      return root < r_end;
    };
    auto next_stage = [&](int& i, int& bt) {
      if (++bt == nb) {
        bt = 0;
        i += kRedWarps;
      }
    };
    auto issue = [&](int i, int bt, int buf) {
      int64_t root;
      int c, r;
      if (i < n_items && decode(i, root, c, r) && col < chunk_cols(c)) {
        const float* src = x + root * f * (int64_t)d + c * kKC + col;
        XW* dst = xb + (size_t)buf * fb * 32 + lane;
        const int j1 = min(f, (bt + 1) * fb);
#pragma unroll 4
        for (int j = bt * fb; j < j1; ++j)
          cp_async<4 * V>(smem_u32(dst + (j - bt * fb) * 32), src + (int64_t)j * d);
      }
      cp_async_commit();
    };
    float acc[V];
    int i = rw, bt = 0, buf = 0;
    issue(i, 0, 0);
#pragma unroll 1
    while (i < n_items) {
      int ni_ = i, nbt = bt;
      next_stage(ni_, nbt);
      issue(ni_, nbt, buf ^ 1);
      cp_async_wait_ring();  // this batch's copies have landed (the next one's in flight)
      int64_t root;
      int c, r;
      const bool live = decode(i, root, c, r) && col < chunk_cols(c);
      if (live) {
        const XW* src = xb + (size_t)buf * fb * 32 + lane;
        const int j0 = bt * fb, j1 = min(f, j0 + fb);
#pragma unroll 5
        for (int j = j0; j < j1; ++j) {
          const XW v = src[(j - j0) * 32];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = j == 0 ? comp(v, e) : acc[e] + comp(v, e);
        }
      }
      if (bt == nb - 1) {
        const int q = i / tb, slot = q % ms, use = q / ms;  // q = t * nch + c
        if (use > 0) mbar_wait(empty_m + 8 * slot, (use - 1) & 1);
        if (live) {
          float* dst = mring + (size_t)slot * kKC * tb + r;
#pragma unroll
          for (int e = 0; e < V; ++e) dst[(col + e) * tb] = acc[e] / fd;
        }
        mbar_arrive(full_m + 8 * slot);
      }
      i = ni_;
      bt = nbt;
      buf ^= 1;
    }
    cp_async_wait_all();
    return;
  }

  // 3. the product warps: slot g = pw, pw + kProdWarps, ... is item g %
  // items (roots 4 (item % nrg) .. + 3, columns 128 (item / nrg) + 4 lane ..
  // + 3) and K part g / items
  const int pw = warp - 1;
  const int nrg = tb / 4, items = nrg * ((o_pad + 127) / 128);
  int moff[NI], wcol[NI], kpart[NI];
#pragma unroll
  for (int ii = 0; ii < NI; ++ii) {
    const int g = pw + kProdWarps * ii, item = g % items;
    moff[ii] = 4 * (item % nrg);
    wcol[ii] = g < items * ks ? (item / nrg) * 128 + 4 * lane : o_pad;
    kpart[ii] = g / items;
  }
  float* red = reinterpret_cast<float*>(smem + lay.red_off);
  int s = 0;
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    float acc[NI][4][4];
#pragma unroll
    for (int ii = 0; ii < NI; ++ii)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ii][r][e] = 0.f;
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      const int q = t * nch + c, slot = q % ms;
      mbar_wait(full_m + 8 * slot, (q / ms) & 1);
      const int kc = chunk_cols(c);
      const float* mslot = mring + (size_t)slot * kKC * tb;
#pragma unroll 1
      for (int k0 = 0; k0 < kc; k0 += kw, ++s) {
        const int wslot = s % nwb;
        mbar_wait(full_w + 8 * wslot, (s / nwb) & 1);
        const float* wb = wring + (size_t)wslot * kw * o_pad;
        const int rows = min(kw, kc - k0);
#pragma unroll
        for (int ii = 0; ii < NI; ++ii) {
          if (wcol[ii] < o_pad) {
            // rows k with (c * kKC + k0 + k) = kpart (mod ks)
            int k = (kpart[ii] - (c * kKC + k0) % ks + ks) % ks;
#pragma unroll 4
            for (; k < rows; k += ks) {
              const float4 m4 = *reinterpret_cast<const float4*>(mslot + (k0 + k) * tb + moff[ii]);
              const float4 w4 = *reinterpret_cast<const float4*>(wb + k * o_pad + wcol[ii]);
              const float mv[4] = {m4.x, m4.y, m4.z, m4.w}, wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
              for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[ii][r][e] = fmaf(mv[r], wv[e], acc[ii][r][e]);
            }
          }
        }
        mbar_arrive(empty_w + 8 * wslot);
      }
      mbar_arrive(empty_m + 8 * slot);
    }
    // the tile's outputs; a split K's parts are added in order 0, 1, ...
    if (ks > 1) {  // then NI = 1 and every product warp holds one part
      if (kpart[0] > 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(red + ((pw * 4 + r) * 32 + lane) * 4) =
              make_float4(acc[0][r][0], acc[0][r][1], acc[0][r][2], acc[0][r][3]);
      }
      product_sync();
      if (kpart[0] == 0) {
        for (int p = 1; p < ks; ++p) {
          const int src = pw + p * items;  // the warp of part p
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 v =
                *reinterpret_cast<const float4*>(red + ((src * 4 + r) * 32 + lane) * 4);
            acc[0][r][0] += v.x;
            acc[0][r][1] += v.y;
            acc[0][r][2] += v.z;
            acc[0][r][3] += v.w;
          }
        }
      }
    }
    const int64_t root0 = r_begin + (int64_t)t * tb;
#pragma unroll
    for (int ii = 0; ii < NI; ++ii) {
      if (wcol[ii] < o && kpart[ii] == 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int64_t root = root0 + moff[ii] + r;
          if (root < r_end)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (wcol[ii] + e < o) out[root * o + wcol[ii] + e] = acc[ii][r][e];
        }
      }
    }
    if (ks > 1) product_sync();  // the partial tiles are read before the next tile's
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

template <int IPW, int NU, bool PAIRS, typename XT>
int launch_bf16(const void* x, const void* w, void* out, int64_t b, int f, int d, int o_pad,
                int word, int g_rows, int n_wbufs, int tb, int grid, int ksplit, size_t smem,
                cudaStream_t s) {
  static size_t done = 0;
  if (int e = set_smem(mean_project_bf16_kernel<IPW, NU, PAIRS, XT>, smem, &done)) return e;
  mean_project_bf16_kernel<IPW, NU, PAIRS, XT><<<(unsigned)grid, kThreads, smem, s>>>(
      (const XT*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, b, f, d, o_pad, word,
      g_rows, n_wbufs, tb, ksplit);
  return (int)cudaGetLastError();
}

template <int IPW, typename XT>
int launch_bf16_nu(const void* x, const void* w, void* out, int64_t b, int f, int d, int o_pad,
                   int word, int g_rows, int n_wbufs, int tb, int grid, int ksplit,
                   size_t smem, cudaStream_t s) {
  const bool pairs = d % 2 == 0;
  const int words = pairs ? d / 2 : d;
#define TSG_LAUNCH(NU, PAIRS)                                                               \
  launch_bf16<IPW, NU, PAIRS, XT>(x, w, out, b, f, d, o_pad, word, g_rows, n_wbufs, tb, grid, \
                                  ksplit, smem, s)
  if (pairs) return words <= kThreads ? TSG_LAUNCH(1, true) : TSG_LAUNCH(2, true);
  if (words <= kThreads) return TSG_LAUNCH(1, false);
  if (words <= 2 * kThreads) return TSG_LAUNCH(2, false);
  return TSG_LAUNCH(4, false);
#undef TSG_LAUNCH
}

}  // namespace

// bf16: x (b, f, d) of x_bytes-byte elements (2: bf16, 4: f32), w (d, o_pad)
// bf16 with o_pad a power of two in [16, 1024] and a 16-byte-aligned base,
// out (b, o_pad) bf16, d <= 2048. `grid` persistent blocks (at most one per
// 4 roots) each take an even share of the 4-root units and walk it in tiles
// of tb roots (4, 8, 16 or 32); ksplit 2 splits K in two
// halves (at most 8 pairs of 16 output columns and 8 roots), else 1;
// (o_pad / 16) * ceil(tb / 8) * ksplit <= 128. word_bytes (16, 8 or 4)
// divides x's base address and 4*f*d*x_bytes; 16 divides g_rows*d*x_bytes.
// n_wbufs >= ceil(d / 64) keeps W
// resident, fewer form a ring of W chunks. smem_bytes must hold the layout
// (Layout above, as the plan computes it), within 232,448.
extern "C" int tsg_mean_project_bf16(const void* x, const void* w, void* out, long long b,
                                     int f, int d, int o_pad, int x_bytes, int word_bytes,
                                     int g_rows, int n_wbufs, int tb, int grid, int ksplit,
                                     long long smem_bytes, void* stream) {
  if (word_bytes != 16 && word_bytes != 8 && word_bytes != 4) return (int)cudaErrorInvalidValue;
  if (x_bytes != 2 && x_bytes != 4) return (int)cudaErrorInvalidValue;
  if (tb != 4 && tb != 8 && tb != 16 && tb != 32) return (int)cudaErrorInvalidValue;
  if ((ksplit != 1 && ksplit != 2) || n_wbufs < 1 || g_rows < 1 || d < 1 || d > 2048 || f < 1)
    return (int)cudaErrorInvalidValue;
  if (o_pad < 16 || o_pad > 1024 || (o_pad & (o_pad - 1))) return (int)cudaErrorInvalidValue;
  if (grid < 1 || grid > (b + 3) / 4) return (int)cudaErrorInvalidValue;
  const Layout lay(d, o_pad, x_bytes, g_rows, n_wbufs, tb, ksplit);
  if (lay.total > (size_t)smem_bytes || smem_bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int items = (o_pad / 16) * ((tb + 7) / 8) * ksplit;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)smem_bytes;
#define TSG_LAUNCH_X(IPW, XT)                                                                   \
  launch_bf16_nu<IPW, XT>(x, w, out, b, f, d, o_pad, word_bytes, g_rows, n_wbufs, tb, grid, \
                          ksplit, smem, s)
#define TSG_LAUNCH(IPW) \
  (x_bytes == 4 ? TSG_LAUNCH_X(IPW, float) : TSG_LAUNCH_X(IPW, __nv_bfloat16))
  if (items <= kWarps) return TSG_LAUNCH(1);
  if (items <= 2 * kWarps) return TSG_LAUNCH(2);
  if (items <= 4 * kWarps) return TSG_LAUNCH(4);
  if (items <= 8 * kWarps) return TSG_LAUNCH(8);
  return (int)cudaErrorInvalidValue;
#undef TSG_LAUNCH
#undef TSG_LAUNCH_X
}

namespace {

template <int V, int NI>
int launch_f32(const void* x, const void* w, void* out, int64_t b, int f, int d, int o,
               int o_pad, int fb, int tb, int grid, int ms, int kw, int nwb, size_t smem,
               cudaStream_t s) {
  static size_t done = 0;
  if (int e = set_smem(mean_project_f32_kernel<V, NI>, smem, &done)) return e;
  mean_project_f32_kernel<V, NI><<<(unsigned)grid, kF32Warps * 32, smem, s>>>(
      (const float*)x, (const float*)w, (float*)out, b, f, d, o, o_pad, fb, tb, ms, kw, nwb);
  return (int)cudaGetLastError();
}

template <int V>
int launch_f32_ni(const void* x, const void* w, void* out, int64_t b, int f, int d, int o,
                  int o_pad, int fb, int tb, int grid, int ms, int kw, int nwb, int ni,
                  size_t smem, cudaStream_t s) {
#define TSG_LAUNCH(NI) \
  launch_f32<V, NI>(x, w, out, b, f, d, o, o_pad, fb, tb, grid, ms, kw, nwb, smem, s)
  switch (ni) {
    case 1: return TSG_LAUNCH(1);
    case 2: return TSG_LAUNCH(2);
    case 3: return TSG_LAUNCH(3);
    case 4: return TSG_LAUNCH(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TSG_LAUNCH
}

}  // namespace

// f32: x (b, f, d) f32, its base 8-byte aligned for v = 2 (d even) and
// 4-byte aligned for v = 1; w (d, o_pad) f32 with o_pad a multiple of 4, at
// least o, and a 16-byte-aligned base; out (b, o) f32. `grid` persistent
// blocks (at most b) take even shares of the roots in tiles of tb (a
// multiple of 4, at most 16); fb x rows a reducer batch (1 .. 32); ms mean
// slots (more than ceil(11 / tb)); nwb W buffers of kw rows (kw divides
// 32 v); ni product items a product warp (1 .. 4; 4 ni >= items * ks, items
// = (tb / 4) ceil(o_pad / 128), ks = f32_ks; 1 when K is split). smem_bytes holds the layout
// (F32Layout above, as kernels/mean_project.py::f32_plan computes it),
// within 232,448.
extern "C" int tsg_mean_project_f32(const void* x, const void* w, void* out, long long b, int f,
                                    int d, int o, int o_pad, int v, int fb, int tb, int grid,
                                    int ms, int kw, int nwb, int ni, long long smem_bytes,
                                    void* stream) {
  if (v != 1 && v != 2) return (int)cudaErrorInvalidValue;
  if (b < 1 || f < 1 || d < 1 || o < 1 || o_pad < o || o_pad % 4) return (int)cudaErrorInvalidValue;
  if (v == 2 && d % 2) return (int)cudaErrorInvalidValue;
  if (tb < 4 || tb % 4 || tb > 16 || ms * tb < kRedWarps + tb || nwb < 1 || kw < 1 ||
      (32 * v) % kw || fb < 1 || fb > 32 || 8 * (2 * ms + 2 * nwb) > kF32BarBytes)
    return (int)cudaErrorInvalidValue;
  const int ks = f32_ks(tb, o_pad), items = (tb / 4) * ((o_pad + 127) / 128);
  if (grid < 1 || grid > b || ni * kProdWarps < items * ks || (ks > 1 && ni != 1))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w) & 15) || (reinterpret_cast<uintptr_t>(x) & (4 * v - 1)))
    return (int)cudaErrorInvalidValue;
  const F32Layout lay(32 * v, fb, tb, ms, kw, o_pad, nwb, ks);
  if (lay.total > (size_t)smem_bytes || smem_bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)smem_bytes;
#define TSG_LAUNCH(V) \
  launch_f32_ni<V>(x, w, out, b, f, d, o, o_pad, fb, tb, grid, ms, kw, nwb, ni, smem, s)
  return v == 2 ? TSG_LAUNCH(2) : TSG_LAUNCH(1);
#undef TSG_LAUNCH
}


