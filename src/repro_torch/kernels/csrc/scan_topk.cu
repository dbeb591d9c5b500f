// Exact predicate-masked brute scan with a top-k, for Hopper (sm_90a), over
// an f32 corpus, its bf16 replica or its int8 replica; its bitmask form; and
// its windowed form over a position-ordered corpus. The bitmask and windowed
// forms also take a bf16 corpus (an index stored in bf16), as the
// reference's kernels take any corpus dtype and upcast in their bodies.
//
// Replaces: src/repro/kernels/scan_topk.py:scan_topk_kernel (the Pallas TPU
// kernel behind the planner's strategy="scan" lanes, which the reference
// also runs on the bf16 replica),
// src/repro/kernels/scan_topk.py:scan_topk_q8_kernel (its int8-replica
// form, quant="int8"),
// src/repro/kernels/scan_topk.py:scan_topk_mask_kernel (the predicate
// compiler's bitmask fallback: one (N, 1) f32 row mask shared by the batch,
// > 0 passes, in place of the boxes) and
// src/repro/kernels/scan_topk.py:scan_topk_windows_kernel (the hybrid
// planner's per-node scan over each lane's (start, count) windows).
//
// These kernels keep each query's running top-k in shared memory and
// stage the attrs in rows of 8, so they take k <= 64 (KMAX) and m <= 8
// (MMAX); ops.py sends any other 1 <= k <= N or m >= 1 to the wide form in
// scan_topk_wide.cu, which computes the same answers bit for bit. That
// file includes this one (SCAN_TOPK_DEVICE_ONLY: the kernels without this
// file's entries): its box, windowed and bitmask forms run box_scan_body
// and mask_partial_body with a candidate-list sink (ListSink) in place of
// the running top-k, and window_cover and the bitmask compaction below.
//
// Computes, per query b: the k rows with the smallest sum_j (q[b,j] -
// row(r)[j])^2 among rows r whose attrs pass all(qlo[b] <= a <= qhi[b])
// (NaN fails), ascending by (distance, row id) -- distance ties go to the
// lowest id, exactly lax.top_k -- and (-1, +inf) past the in-range count.
// row(r) is corpus[r] (f32), float(corpus[r]) (bf16) or
// float(qcorpus[r]) * qscale[r] (int8, the product rounded on its own as
// the reference's dequant_rows writes it). The bitmask form tests
// mask[r] > 0 (NaN fails) instead of the box; the windowed form only looks
// at rows inside the lane's windows and returns their positions.
//
// Bound on the H100 (the windowed form's comes with its design below): it
// depends on the boxes. Reading the corpus and attrs once is ~3.1 GB at N=1M, d=768 in f32 (~0.92 ms at 3.35 TB/s),
// ~1.55 GB in bf16 (~0.46 ms) and ~0.79 GB in int8 (~0.24 ms). Only
// (query, row) pairs whose row passes the box need a distance, 3 flops
// per dimension (sub + fma): with every pair passing that is 5.9e11 flop
// at B=256, ~8.8 ms at 67 TFLOP/s fp32, but with the planner's scan
// lanes (boxes under 10% of N) it is under 0.9 ms, so the bound is the
// bytes. chip_smoke.py computes it from its own boxes. The direct form
// needs two fp32 instructions (sub, fma) per (passing pair, dimension):
// chip_smoke.py's 13.3M passing pairs x 768 are 2.0e10, ~0.61 ms at one
// instruction a lane a cycle. This design reads the corpus about once per
// batch of up to 256 queries and scores only the passing pairs, but feeds
// each (pair, 4 dimensions) from two 16-byte shared-memory loads, a
// quarter-warp's eight at a time, so a sparse tile is bound by
// shared-memory wavefronts (128 bytes a cycle an SM), not by the fp32
// pipes.
// The bitmask form needs a distance only for the rows its mask passes,
// for every query: 3 flops per (pair,
// dimension) make 4.75 ms at 67 TFLOP/s for chip_smoke.py's 539,333
// passing rows x 256 queries x 768, the bound; the direct form needs two
// fp32 instructions (sub, fma) per (pair, dimension), 2.12e11 there: 6.3
// ms at one instruction a lane a cycle is its ceiling.
//
// Design: on the TPU the grid walks N in order and carries the running
// top-k from step to step. H100 blocks run in no order, so this is two
// passes:
//   pass 1 (box_scan_kernel): a block of 512 threads owns BQ=256 queries
//     (the largest bucket the service sends, so a batch reads the corpus
//     once; a larger batch takes one block row per 256 queries) and pulls
//     row tiles of TR rows (256, or 128 / 64 where a large k leaves less
//     shared memory) from an atomic counter until none is left; the grid
//     is one block an SM per query block, so a region of dense boxes does
//     not leave other blocks idle. Per tile:
//     - the tile's attrs are staged once and tested against the 256 boxes
//       (two threads a query, a bit per row, no branch), and each query's
//       passing rows counted by row class (row mod 8);
//     - a tile with no passing pair reads no corpus row;
//     - a sparse tile (under a quarter of BQ x TR pairs pass) computes only
//       its passing pairs, in rounds of 8,192 slots, while the tile's rows
//       and the queries stream through shared memory in 16-wide d slabs;
//       each thread keeps the accumulators of its (up to 16) slots in
//       registers. The slots are laid out so that a quarter-warp's eight
//       lanes read rows of eight distinct classes and queries of one group
//       of eight: the 16-byte loads of both then hit eight distinct bank
//       groups (rows lie 80 bytes apart), where pairs in query-then-row
//       order hit the row banks in no order (about 2.5 wavefronts a
//       quarter, not 1). Each query's thread writes its pairs' slots;
//     - a dense tile computes all BQ x 32 pairs of each 32-row sub-tile with
//       a 4 x 4 register tile a thread, then masks them: at every pass this
//       is the fp32 pipes' rate, about twice the sparse loop's;
//     - the thread that computed a pair offers it to its query's buffer
//       when it is below the query's k-th entry, then one thread per query
//       inserts its buffer into that query's running top-k in shared
//       memory (a query whose buffer overflows walks all its pairs), by
//       (distance, id), so neither the tile order nor the pair order
//       matters and a warp waits on few inserts.
//     Slabs are double-buffered: queries (and f32 rows) by 16-byte cp.async
//     copies; bf16 and int8 rows by 16-byte loads held in registers across
//     the previous slab's arithmetic, widened (and an int8 one scaled,
//     __fmul_rn as the reference's dequant_rows) as they are stored, so
//     the inner loops are the f32 ones. Every distance, sparse or dense,
//     is one chain acc = fmaf(q_j - row_j, q_j - row_j, acc) over ascending
//     j (zero-padded past d, which adds exact zeros), so the path a tile
//     takes never changes a bit and the bitmask form, which runs the same
//     chain, equals this one on the mask as a one-attribute box. Each block
//     writes its partial top-k; tile counts (empty, sparse, dense) go to
//     the wrapper's scratch beside the tile counters.
//   pass 2 (scan_merge_kernel): one block per query merges the block
//     partials by (distance, id) in k rounds of a block-wide arg-min.
// The wrapper plans the tile height and the grid (ops._scan_plan, which
// also sizes the shared memory this file checks) and allocates the partial
// buffers, the scratch and the outputs.
//
// The bitmask form's mask is shared by the batch and scattered over the
// corpus (a filter expression's rows), so nearly every 64-row tile has a
// passing row and a tile-skipping walk would compute every pair. It first
// compacts: mask_count_kernel counts each 8,192-row segment's passing rows,
// mask_compact_kernel writes their ids in ascending order (a warp ballot,
// each lane's rank in it, a prefix over the 8 warps, each segment at the
// sum of the earlier counts) and the list's length, on the device (no
// host sync). Its pass 1 (mask_partial_kernel) splits that length evenly
// over the chunks, in 64-row tiles, so a mask dense in one region does not
// starve the other blocks; a block owns 128 queries and gathers its
// chunk's rows by id with 16-byte cp.async copies into a double-buffered
// 32-wide slab (the query slab beside it), each thread holding 8 queries
// x 4 rows in registers. Each distance is the box scan's one fmaf chain
// of (q_j - row_j)^2 over ascending j, so the bitmask form's distances and
// ties are the box scan's bit for bit on the same rows; pass 2 is the box
// scan's.
//
// The windowed form is the box scan (f32 or bf16) with a coverage mask. Windows are
// DFS extents of tree nodes, so across lanes they nest or do not meet, and
// a row that many lanes cover would be read once per lane by a block per
// (lane, window). Instead a pre-pass (window_cover_kernel, a thread per
// window, a warp per long one) sets each window's rows, clipped to [0,
// N), in a zeroed (B, ceil(N / 32)) bitmap -- whole words stored, the two
// edge words atomicOr'ed, since two windows of a lane may share a word
// (and overlapping windows then give their union) -- and marks, per
// (query block, row tile), whether any lane of the block covers the
// tile. Pass 1
// is box_scan_kernel<T, VEC, true>: a tile that no lane of its block
// covers is skipped before its attrs are staged, and each box-test word
// is ANDed with the lane's coverage word, so everything after (class
// counts, sparse and dense rounds, fold) is the box scan's and each
// covered row tile is read once per query block. Pass 2 is the box scan's
// merge. The ids are positions, unique, so the (distance, position) order
// is the reference's tie order, and a lane whose windows cover [0, N)
// gets the box scan's answer bit for bit. Its bound: the attrs of every
// covered row and the vector of every row that passes a covering lane's
// box, each read once, and 3 flops per dimension of each passing (lane,
// row) pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int DS = 32, MMAX = 8, KMAX = 64;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ bool lex_less(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// ---- the box scan (f32, bf16 and int8 corpora)

constexpr int BT = 512;             // threads a block
constexpr int BQ = 256;             // queries a block owns
constexpr int SD = 16;              // d-slab width
constexpr int SLD = SD + 4;         // staged row stride (80 bytes): the
                                    // float4 loads of 8 consecutive rows
                                    // hit 8 distinct bank groups
constexpr int PPT = 16;             // slots a thread holds in a round
constexpr int RP = BT * PPT;        // slots of a sparse round
constexpr int TD = 32;              // rows of a dense sub-tile
constexpr int DLD = TD + 1;         // the dense sub-tile's distance stride
constexpr int CAP = 24;             // fold candidates a query buffers
                                    // (in the idle stages: 2 CAP BQ words)
constexpr unsigned NOPAIR = 0xffffffffu;

// The wide forms' sink (scan_topk_wide.cu), in place of the running
// top-k: every computed pair whose distance is <= tau[b] and finite goes
// to query b's candidate list list[b * cap ..] as its key (list_key);
// count[b] counts them all, past cap too (an overflow). A null tau is
// +inf (the sample pass). A pass over 1 in tstride row tiles (list tiles
// of the bitmask form) samples the rows.
struct ListSink {
  const float* tau;
  unsigned long long* list;
  int* count;
  int cap;
  int tstride;
};

// (distance, id) as one key whose unsigned order is the (distance, id)
// order: non-negative floats order as their bits
__device__ __forceinline__ unsigned long long list_key(float dv, int id) {
  return (unsigned long long)__float_as_uint(dv) << 32 | (unsigned)id;
}

// Shared memory of box_scan_kernel in 4-byte words, for row tiles of `tr`
// rows (64, 128 or 256): two slab stages of BQ + tr rows, the top-k
// dists and ids (k x BQ each), a round's slots and then their distances
// (the larger of a sparse round and a dense sub-tile), the pass bits, the
// tile's attrs
// (rows of MMAX floats) and int8 scales, the class counts (8 x BQ
// bytes) and group slot bases (BQ / 8 + 1), 16 ints of bookkeeping, and
// each query's k-th entry and buffered pair count (3 x BQ).
// ops._scan_plan computes the same number.
__host__ __device__ constexpr int box_scan_smem_words(int tr, int k) {
  return 2 * (BQ + tr) * SLD + 2 * k * BQ + (RP > BQ * DLD ? RP : BQ * DLD) +
         (tr / 32) * BQ + tr * MMAX + tr + 2 * BQ + BQ / 8 + 1 + 16 + 3 * BQ;
}

template <typename T> struct Vec;        // elements a 16-byte load holds
template <> struct Vec<float> { static constexpr int V = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int V = 8; };
template <> struct Vec<int8_t> { static constexpr int V = 16; };

template <typename T>
__device__ __forceinline__ T zero_of() { return static_cast<T>(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ float widen(__nv_bfloat16 v, float) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v, float s) {
  return __fmul_rn(static_cast<float>(v), s);   // never fused into q - row
}

// One query's running top-k, column q of the (k, BQ) arrays td/ti, kept
// ascending by (distance, id); (wd, wi) caches its last entry. The slot
// comes by binary search, then the entries after it move down one.
__device__ __forceinline__ void topk_insert(float* td, int* ti, int k,
                                            float dv, int id, float& wd,
                                            int& wi) {
  if (!lex_less(dv, id, wd, wi)) return;
  int lo = 0, hi = k - 1;              // the first entry above (dv, id)
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lex_less(dv, id, td[mid * BQ], ti[mid * BQ])) hi = mid;
    else lo = mid + 1;
  }
#pragma unroll 4
  for (int p = k - 1; p > lo; --p) {
    td[p * BQ] = td[(p - 1) * BQ];
    ti[p * BQ] = ti[(p - 1) * BQ];
  }
  td[lo * BQ] = dv;
  ti[lo * BQ] = id;
  wd = td[(k - 1) * BQ];
  wi = ti[(k - 1) * BQ];
}

// Streams the d slabs of `qrows` queries (q0 + i, zeros past nq) and
// `srows` rows (rbase + i, zeros past nrows) through the two stages and
// calls compute(Qs, Rs) on each slab in ascending order. Queries, and f32
// rows, come by cp.async; bf16 and int8 rows by 16-byte loads (VEC) or
// scalar ones into registers, issued before the previous slab's compute
// and widened into the stage after it. `sc` holds the rows' int8 scales.
template <typename T, bool VEC, typename F>
__device__ __forceinline__ void stream_slabs(
    float* stage, int stage_words, const T* __restrict__ corpus,
    const float* sc, const float* __restrict__ q, int q0, int nq, int qrows,
    long long rbase, int nrows, int srows, int d, F&& compute) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int V = Vec<T>::V;
  const int tid = threadIdx.x;
  const int nslab = (d + SD - 1) / SD;
  // the slab of rows, held in registers between its load and its store
  uint4 raw4 = make_uint4(0u, 0u, 0u, 0u);
  T raw1[SD * BQ / BT];

  auto issue = [&](int s) {
    float* Qs = stage + (s & 1) * stage_words;
    float* Rs = Qs + BQ * SLD;
    const int k0 = s * SD;
    if (VEC) {
      for (int e = tid; e < qrows * (SD / 4); e += BT) {
        const int i = e / (SD / 4), c = (e % (SD / 4)) * 4, gk = k0 + c;
        int bytes = min(16, max(0, (d - gk) * 4));
        bytes = i < nq ? bytes : 0;
        cp_async16(Qs + i * SLD + c,
                   bytes ? q + (size_t)(q0 + i) * d + gk : q, bytes);
      }
    } else {
      for (int e = tid; e < qrows * SD; e += BT) {
        const int i = e / SD, c = e % SD, gk = k0 + c;
        const bool in = i < nq && gk < d;
        cp_async4(Qs + i * SLD + c, in ? q + (size_t)(q0 + i) * d + gk : q,
                  in ? 4 : 0);
      }
    }
    if constexpr (F32) {
      const float* cf = reinterpret_cast<const float*>(corpus);
      if (VEC) {
        for (int e = tid; e < srows * (SD / 4); e += BT) {
          const int i = e / (SD / 4), c = (e % (SD / 4)) * 4, gk = k0 + c;
          int bytes = min(16, max(0, (d - gk) * 4));
          bytes = i < nrows ? bytes : 0;
          cp_async16(Rs + i * SLD + c,
                     bytes ? cf + (size_t)(rbase + i) * d + gk : cf, bytes);
        }
      } else {
        for (int e = tid; e < srows * SD; e += BT) {
          const int i = e / SD, c = e % SD, gk = k0 + c;
          const bool in = i < nrows && gk < d;
          cp_async4(Rs + i * SLD + c,
                    in ? cf + (size_t)(rbase + i) * d + gk : cf, in ? 4 : 0);
        }
      }
    } else if (VEC) {                  // one 16-byte load a thread at most
      const int e = tid;
      const int i = e / (SD / V), c = (e % (SD / V)) * V, gk = k0 + c;
      if (i < srows) {
        raw4 = (i < nrows && gk < d)
                   ? __ldg(reinterpret_cast<const uint4*>(
                         corpus + (size_t)(rbase + i) * d + gk))
                   : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
#pragma unroll
      for (int u = 0; u < SD * BQ / BT; ++u) {
        const int e = tid + u * BT;
        const int i = e / SD, c = e % SD, gk = k0 + c;
        raw1[u] = (i < nrows && gk < d)
                      ? corpus[(size_t)(rbase + i) * d + gk]
                      : zero_of<T>();
      }
    }
  };
  auto put = [&](int s) {              // bf16 / int8 rows into stage s
    if constexpr (!F32) {
      float* Rs = stage + (s & 1) * stage_words + BQ * SLD;
      if (VEC) {
        const int e = tid;
        const int i = e / (SD / V), c = (e % (SD / V)) * V;
        if (i < srows) {
          const T* v = reinterpret_cast<const T*>(&raw4);
          const float s8 = i < nrows ? sc[i] : 0.f;
#pragma unroll
          for (int u = 0; u < V; u += 4)
            *reinterpret_cast<float4*>(Rs + i * SLD + c + u) =
                make_float4(widen(v[u], s8), widen(v[u + 1], s8),
                            widen(v[u + 2], s8), widen(v[u + 3], s8));
        }
      } else {
#pragma unroll
        for (int u = 0; u < SD * BQ / BT; ++u) {
          const int e = tid + u * BT;
          const int i = e / SD, c = e % SD;
          if (i < srows)
            Rs[i * SLD + c] = widen(raw1[u], i < nrows ? sc[i] : 0.f);
        }
      }
    }
  };

  issue(0);
  cp_async_commit();
  put(0);
  for (int s = 0; s < nslab; ++s) {
    if (s + 1 < nslab) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Qs = stage + (s & 1) * stage_words;
    compute(Qs, Qs + BQ * SLD);
    if (s + 1 < nslab) put(s + 1);
    __syncthreads();
  }
  cp_async_wait<0>();
}

// Pass 1 of the box scan. Grid (blocks, ceil(B / BQ)); block (x, y) owns
// queries [y * BQ, y * BQ + BQ) and takes row tiles from sched[y] until
// they run out; sched[gridDim.y + 0..2] count empty, sparse and dense
// tiles. Writes its top-k to part_d/part_i[(b * gridDim.x + x) * k + j].
// The windowed form (WIN) also reads `cov`: the (B, ceil(N / 32)) coverage
// bitmap, then the (gridDim.y, ntiles) byte flags of the tiles some lane
// of a query block covers; sched[gridDim.y] counts the tiles it skips
// uncovered, and the empty, sparse and dense counts follow. The wide
// forms' instance (LIST, k = 0) hands its pairs to the candidate lists
// of `ls` instead, takes any m (the attrs tested MMAX at a time) and, as
// a sample pass, 1 in ls.tstride row tiles (under WIN too: tile t's flag
// is read at its own index, t * tstride).
template <typename T, bool VEC, bool WIN, bool LIST>
__device__ __forceinline__ void
box_scan_body(const T* __restrict__ corpus, const float* __restrict__ scale,
              const float* __restrict__ attrs, const float* __restrict__ q,
              const float* __restrict__ qlo, const float* __restrict__ qhi,
              const unsigned* __restrict__ cov, float* __restrict__ part_d,
              int* __restrict__ part_i, int* __restrict__ sched, int B, int N,
              int d, int m, int k, int tr, const ListSink& ls) {
  extern __shared__ float4 bsm4[];
  float* stage = reinterpret_cast<float*>(bsm4);
  const int stage_words = (BQ + tr) * SLD;
  float* topd = stage + 2 * stage_words;           // (k, BQ)
  int* topi = reinterpret_cast<int*>(topd + k * BQ);
  float* rd = reinterpret_cast<float*>(topi + k * BQ);
  unsigned* bits = reinterpret_cast<unsigned*>(
      rd + (RP > BQ * DLD ? RP : BQ * DLD));       // (tr / 32, BQ)
  float* at = reinterpret_cast<float*>(bits + (tr / 32) * BQ);  // (tr, 8)
  float* sc = at + tr * MMAX;                      // (tr)
  unsigned char* cc = reinterpret_cast<unsigned char*>(sc + tr);  // (8, BQ)
  int* gofs = reinterpret_cast<int*>(cc + 8 * BQ);  // (BQ / 8 + 1)
  int* misc = gofs + BQ / 8 + 1;                   // tile, pair count
  float* wqd = reinterpret_cast<float*>(misc + 16);  // (BQ) k-th entries
  int* wqi = reinterpret_cast<int*>(wqd + BQ);      // (BQ)
  int* ncand = wqi + BQ;                           // (BQ) buffered pairs
  // the fold's candidates, in the stages (idle then): (CAP, BQ) each
  float* cdd = stage;
  int* cdi = reinterpret_cast<int*>(stage + CAP * BQ);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * BQ;
  const int nq = min(BQ, B - q0);
  const int ts = LIST ? ls.tstride : 1;            // tiles a step skips
  const int alltiles = (N + tr - 1) / tr;
  const int ntiles = (alltiles + ts - 1) / ts;
  const int nw = tr / 32;
  int* stats = sched + gridDim.y + (WIN ? 1 : 0);

  for (int e = tid; e < k * BQ; e += BT) {
    topd[e] = CUDART_INF_F;
    topi[e] = -1;
  }
  for (int e = tid; e < BQ; e += BT) {
    // the offer bar: the k-th entry as it runs, or the list's tau
    wqd[e] = LIST && ls.tau != nullptr && e < nq ? ls.tau[q0 + e]
                                                 : CUDART_INF_F;
    wqi[e] = -1;
    ncand[e] = 0;
  }
  float wd = CUDART_INF_F;             // the fold thread's k-th entry
  int wi = -1;

  for (;;) {
    __syncthreads();
    if (tid == 0) misc[0] = atomicAdd(sched + blockIdx.y, 1);
    __syncthreads();
    const int tile = misc[0];
    if (tile >= ntiles) break;
    if constexpr (WIN) {               // no lane of the block covers it
      const unsigned char* tflag = reinterpret_cast<const unsigned char*>(
          cov + (size_t)B * ((N + 31) >> 5));
      if (!tflag[(size_t)blockIdx.y * alltiles + (size_t)tile * ts]) {
        if (tid == 0) atomicAdd(stats - 1, 1);
        continue;
      }
    }
    const long long r0 = (long long)tile * ts * tr;
    const int nr = (int)min((long long)tr, N - r0);
    const int qi = tid & (BQ - 1), half = tid / BQ;
    // the attrs MMAX at a time (one group unless a wide form's m > 8), the
    // groups' pass bits ANDed
    for (int a0 = 0; a0 < (LIST ? m : 1); a0 += MMAX) {
      if (a0 > 0) __syncthreads();     // the last group's tests read `at`
      // attrs rows of MMAX floats: 0 past m (the box is open there), NaN
      // past the tile's last row (it fails every box)
      for (int e = tid; e < tr * MMAX; e += BT) {
        const int r = e / MMAX, a = a0 + e % MMAX;
        at[e] = r < nr ? (a < m ? attrs[(r0 + r) * m + a] : 0.f)
                       : CUDART_NAN_F;
      }
      if constexpr (sizeof(T) == 1)
        if (a0 == 0)
          for (int e = tid; e < nr; e += BT) sc[e] = scale[r0 + e];
      __syncthreads();

      // the boxes: thread (half, qi) tests the rows of its half of the
      // 32-row words, a bit per row, without a branch
      float lo[MMAX], hi[MMAX];
#pragma unroll
      for (int j = 0; j < MMAX; ++j) {
        const int a = a0 + j;
        // queries past B get the empty box: no row ever passes
        lo[j] = a >= m ? -CUDART_INF_F
                : qi < nq ? qlo[(size_t)(q0 + qi) * m + a] : CUDART_INF_F;
        hi[j] = a >= m ? CUDART_INF_F
                : qi < nq ? qhi[(size_t)(q0 + qi) * m + a] : -CUDART_INF_F;
      }
      const float4* a4 = reinterpret_cast<const float4*>(at);
      for (int w = half * (nw / 2); w < (half + 1) * (nw / 2); ++w) {
        unsigned b = 0u;
#pragma unroll 8
        for (int rr = 0; rr < 32; ++rr) {
          const float4 x = a4[(w * 32 + rr) * (MMAX / 4)];
          bool ok = (x.x >= lo[0]) & (x.x <= hi[0]) & (x.y >= lo[1]) &
                    (x.y <= hi[1]) & (x.z >= lo[2]) & (x.z <= hi[2]) &
                    (x.w >= lo[3]) & (x.w <= hi[3]);
          if (m - a0 > 4) {            // the same branch in every thread
            const float4 y = a4[(w * 32 + rr) * (MMAX / 4) + 1];
            ok = ok & (y.x >= lo[4]) & (y.x <= hi[4]) & (y.y >= lo[5]) &
                 (y.y <= hi[5]) & (y.z >= lo[6]) & (y.z <= hi[6]) &
                 (y.w >= lo[7]) & (y.w <= hi[7]);
          }
          b |= (unsigned)ok << rr;
        }
        if constexpr (WIN) {           // only the rows the lane covers
          const int nwords = (N + 31) >> 5, wg = (int)(r0 >> 5) + w;
          b &= qi < nq && wg < nwords
                   ? cov[(size_t)(q0 + qi) * nwords + wg] : 0u;
        }
        bits[w * BQ + qi] = a0 == 0 ? b : bits[w * BQ + qi] & b;
      }
    }
    __syncthreads();
    if (tid < BQ) {                    // cc[c][q]: q's rows = c (mod 8)
      int n[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int w = 0; w < nw; ++w) {
        const unsigned x = bits[w * BQ + tid];
#pragma unroll
        for (int c = 0; c < 8; ++c) n[c] += __popc(x & (0x01010101u << c));
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) cc[c * BQ + tid] = (unsigned char)n[c];
    }
    __syncthreads();
    if (warp == 0) {                   // group g = lane: queries 8g .. 8g+7
      int steps = 0, np = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int n = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) n += cc[c * BQ + 8 * lane + i];
        steps = max(steps, n);
        np += n;
      }
      int inc = steps;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      gofs[lane] = 8 * (inc - steps);
      np = __reduce_add_sync(0xffffffffu, np);
      if (lane == 31) {
        gofs[BQ / 8] = 8 * inc;
        misc[1] = np;
      }
    }
    __syncthreads();
    const int npairs = misc[1], nslots = gofs[BQ / 8];
    if (npairs == 0) {                 // no row of the tile is read
      if (tid == 0) atomicAdd(stats + 0, 1);
      continue;
    }
    float* tdq = topd + tid;           // the fold thread's column
    int* tiq = topi + tid;
    // the fold: the thread that computed a pair offers it to its query's
    // buffer when it is below the query's k-th entry as the round began;
    // then one thread per query inserts its buffer, so a warp waits on a
    // few inserts, not on one per pair that any of its queries takes. A
    // buffer that overflows (a query's first tiles) makes its thread walk
    // all the query's pairs instead.
    auto offer = [&](float dv, int id, int b) {
      if (LIST ? !(dv <= wqd[b] && dv < CUDART_INF_F)
               : !lex_less(dv, id, wqd[b], wqi[b]))
        return;
      const int p = atomicAdd(ncand + b, 1);
      if (p < CAP) {
        cdd[p * BQ + b] = dv;
        cdi[p * BQ + b] = id;
      }
    };
    // walk(take) calls take(distance, id) on each of the query's pairs
    auto fold = [&](auto&& walk) {     // run by thread tid < nq
      const int n = ncand[tid];
      if constexpr (LIST) {            // one list reservation for n pairs
        if (n > 0) {
          const float tau = wqd[tid];
          unsigned long long* dst = ls.list + (size_t)(q0 + tid) * ls.cap;
          int j = atomicAdd(ls.count + q0 + tid, n);
          auto take = [&](float dv, int id) {
            if (dv <= tau && dv < CUDART_INF_F) {
              if (j < ls.cap) dst[j] = list_key(dv, id);
              ++j;
            }
          };
          if (n <= CAP) {
            for (int e = 0; e < n; ++e)
              take(cdd[e * BQ + tid], cdi[e * BQ + tid]);
          } else {
            walk(take);
          }
        }
      } else {
        auto take = [&](float dv, int id) {
          topk_insert(tdq, tiq, k, dv, id, wd, wi);
        };
        if (n <= CAP) {
          for (int e = 0; e < n; ++e)
            take(cdd[e * BQ + tid], cdi[e * BQ + tid]);
        } else {
          walk(take);
        }
        wqd[tid] = wd;
        wqi[tid] = wi;
      }
      ncand[tid] = 0;
    };

    if ((long long)npairs * 4 >= (long long)BQ * nr) {
      // dense: every pair of each 32-row sub-tile, 4 queries x 4 rows a
      // thread (queries ty + 64 i, rows tx + 8 j), then masked
      if (tid == 0) atomicAdd(stats + 2, 1);
      const int ty = tid >> 3, tx = tid & 7;
      for (int sub = 0; sub < nr; sub += TD) {
        const int ns = min(TD, nr - sub);
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        stream_slabs<T, VEC>(
            stage, stage_words, corpus, sc + sub, q, q0, nq, BQ, r0 + sub,
            ns, TD, d, [&](const float* Qs, const float* Rs) {
#pragma unroll
              for (int kk = 0; kk < SD; kk += 4) {
                float4 a[4], b[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  a[i] = *reinterpret_cast<const float4*>(
                      Qs + (ty + 64 * i) * SLD + kk);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  b[j] = *reinterpret_cast<const float4*>(
                      Rs + (tx + 8 * j) * SLD + kk);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    float t = a[i].x - b[j].x;
                    acc[i][j] = fmaf(t, t, acc[i][j]);
                    t = a[i].y - b[j].y;
                    acc[i][j] = fmaf(t, t, acc[i][j]);
                    t = a[i].z - b[j].z;
                    acc[i][j] = fmaf(t, t, acc[i][j]);
                    t = a[i].w - b[j].w;
                    acc[i][j] = fmaf(t, t, acc[i][j]);
                  }
              }
            });
        const int w = sub >> 5;        // sub is a multiple of 32
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int qq = ty + 64 * i, r = tx + 8 * j;
            const bool ok = (bits[w * BQ + qq] >> r) & 1u;
            rd[qq * DLD + r] = ok ? acc[i][j] : CUDART_INF_F;
            if (ok) offer(acc[i][j], (int)(r0 + sub + r), qq);
          }
        __syncthreads();
        if (tid < nq)
          fold([&](auto&& take) {
            for (int r = 0; r < ns; ++r)
              take(rd[tid * DLD + r], (int)(r0 + sub + r));
          });
        __syncthreads();
      }
      continue;
    }

    // sparse: the passing pairs in slots. Group g (queries 8g .. 8g+7) owns
    // slots [gofs[g], gofs[g + 1]): slot gofs[g] + 8 j + c holds entry j of
    // the group's class-c list (its pairs with row = c mod 8, by query, then
    // row), or nothing past the list's end. An aligned 8 slots, one
    // quarter-warp, then reads 8 rows of distinct classes and queries of one
    // group: both 16-byte loads hit 8 distinct bank groups. Slot s of a
    // round runs on thread s % BT, in register slot s / BT.
    if (tid == 0) atomicAdd(stats + 1, 1);
    for (int S0 = 0; S0 < nslots; S0 += RP) {
      // the slots of the round, written by their queries' threads into rd
      // (which takes the distances later): NOPAIR where a list ends
      unsigned* slot = reinterpret_cast<unsigned*>(rd);
      const int nround = min(RP, nslots - S0);
      for (int e = tid; e < nround; e += BT) slot[e] = NOPAIR;
      __syncthreads();
      if (tid < BQ) {                  // whole warps: the prefix shuffles
        const int g = tid >> 3;
        unsigned bw[8];                // the query's pass bits, tr <= 256
#pragma unroll
        for (int w = 0; w < 8; ++w) bw[w] = w < nw ? bits[w * BQ + tid] : 0u;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          // q's first entry in its group's class-c list: the counts of the
          // group's earlier queries (the 8 lanes before it, in its warp)
          const int n = cc[c * BQ + tid];
          int j = n;
#pragma unroll
          for (int o = 1; o < 8; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, j, o, 8);
            if ((lane & 7) >= o) j += v;
          }
          j -= n;
          const unsigned mc = 0x01010101u << c;
#pragma unroll
          for (int w = 0; w < 8; ++w) {
            unsigned x = bw[w] & mc;
            while (x) {
              const int r = w * 32 + __ffs(x) - 1;
              x &= x - 1u;
              const int sl = gofs[g] + 8 * j++ + c - S0;
              if (sl >= 0 && sl < RP)
                slot[sl] = (unsigned)(tid * SLD) << 16 | (unsigned)(r * SLD);
            }
          }
        }
      }
      __syncthreads();
      // register slots in use: the same in every thread
      const int nreg = (nround + BT - 1) / BT;
      unsigned pk[PPT];                // (query * SLD) << 16 | row * SLD
      float acc[PPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        acc[i] = 0.f;
        pk[i] = tid + i * BT < nround ? slot[tid + i * BT] : NOPAIR;
      }
      stream_slabs<T, VEC>(
          stage, stage_words, corpus, sc, q, q0, nq, nq, r0, nr, nr, d,
          [&](const float* Qs, const float* Rs) {
#pragma unroll
            for (int i = 0; i < PPT; ++i) {
              if (i < nreg && pk[i] != NOPAIR) {
                const float* qp = Qs + (pk[i] >> 16);
                const float* rp = Rs + (pk[i] & 0xffffu);
#pragma unroll
                for (int kk = 0; kk < SD; kk += 4) {
                  const float4 a = *reinterpret_cast<const float4*>(qp + kk);
                  const float4 b = *reinterpret_cast<const float4*>(rp + kk);
                  float t = a.x - b.x;
                  acc[i] = fmaf(t, t, acc[i]);
                  t = a.y - b.y;
                  acc[i] = fmaf(t, t, acc[i]);
                  t = a.z - b.z;
                  acc[i] = fmaf(t, t, acc[i]);
                  t = a.w - b.w;
                  acc[i] = fmaf(t, t, acc[i]);
                }
              }
            }
          });
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        if (i < nreg && pk[i] != NOPAIR) {
          rd[tid + i * BT] = acc[i];
          offer(acc[i], (int)(r0 + (pk[i] & 0xffffu) / SLD),
                (int)(pk[i] >> 16) / SLD);
        }
      __syncthreads();
      if (tid < nq)                    // this query's pairs in the round
        fold([&](auto&& take) {
          const int g = tid >> 3;
          for (int c = 0; c < 8; ++c) {
            int j = 0;                 // q's first entry in class list c
            for (int u = 8 * g; u < tid; ++u) j += cc[c * BQ + u];
            const unsigned mc = 0x01010101u << c;
            for (int w = 0; w < nw; ++w) {
              unsigned x = bits[w * BQ + tid] & mc;
              while (x) {
                const int r = w * 32 + __ffs(x) - 1;
                x &= x - 1u;
                const int sl = gofs[g] + 8 * j++ + c;
                if (sl >= S0 && sl < S0 + RP)
                  take(rd[sl - S0], (int)(r0 + r));
              }
            }
          }
        });
      __syncthreads();                 // the buffers are the next stages
    }
  }

  if constexpr (!LIST)
    for (int e = tid; e < nq * k; e += BT) {
      const int qq = e / k, j = e % k;
      const size_t o = ((size_t)(q0 + qq) * gridDim.x + blockIdx.x) * k + j;
      part_d[o] = topd[j * BQ + qq];
      part_i[o] = topi[j * BQ + qq];
    }
}

template <typename T, bool VEC, bool WIN>
__global__ void __launch_bounds__(BT, 1)
box_scan_kernel(const T* __restrict__ corpus, const float* __restrict__ scale,
                const float* __restrict__ attrs, const float* __restrict__ q,
                const float* __restrict__ qlo, const float* __restrict__ qhi,
                const unsigned* __restrict__ cov, float* __restrict__ part_d,
                int* __restrict__ part_i, int* __restrict__ sched, int B,
                int N, int d, int m, int k, int tr) {
  box_scan_body<T, VEC, WIN, false>(corpus, scale, attrs, q, qlo, qhi, cov,
                                    part_d, part_i, sched, B, N, d, m, k, tr,
                                    ListSink{});
}

// The wide forms' box pass (scan_topk_wide.cu): box_scan_body's scoring
// into the candidate lists; shared memory box_scan_smem_words(tr, 0). The
// windowed wide form's instance (WIN) reads window_cover's `cov` as the
// windowed box scan does: uncovered tiles skipped, each box-test word
// ANDed with the lane's coverage word.
template <typename T, bool VEC, bool WIN>
__global__ void __launch_bounds__(BT, 1)
box_scan_list_kernel(const T* __restrict__ corpus,
                     const float* __restrict__ scale,
                     const float* __restrict__ attrs,
                     const float* __restrict__ q,
                     const float* __restrict__ qlo,
                     const float* __restrict__ qhi,
                     const unsigned* __restrict__ cov,
                     int* __restrict__ sched, int B, int N, int d, int m,
                     int tr, ListSink ls) {
  box_scan_body<T, VEC, WIN, true>(corpus, scale, attrs, q, qlo, qhi, cov,
                                   nullptr, nullptr, sched, B, N, d, m, 0,
                                   tr, ls);
}

// Block-wide arg-min of (bd, bi) by (distance, id); every thread returns
// the block's minimum. sd/si are 32-entry shared scratch.
__device__ __forceinline__ void block_lex_min(float& bd, int& bi, float* sd,
                                              int* si) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, bd, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (lex_less(od, oi, bd, bi)) { bd = od; bi = oi; }
  }
  if (lane == 0) { sd[warp] = bd; si[warp] = bi; }
  __syncthreads();
  if (warp == 0) {
    bd = lane < nwarps ? sd[lane] : CUDART_INF_F;
    bi = lane < nwarps ? si[lane] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (lex_less(od, oi, bd, bi)) { bd = od; bi = oi; }
    }
    if (lane == 0) { sd[0] = bd; si[0] = bi; }
  }
  __syncthreads();
  bd = sd[0];
  bi = si[0];
  __syncthreads();
}

// The k smallest finite (d[e], id[e]) of e in [0, total) by (distance, id),
// ids unique, written to out_d/out_i[0..k) with (+inf, -1) past the finite
// count: k rounds of a block arg-min, each above the previous round's pick.
__device__ void block_topk(const float* d, const int* id, int total, int k,
                           float* out_d, int* out_i, float* sd, int* si) {
  const int tid = threadIdx.x;
  float prev_d = -CUDART_INF_F;
  int prev_i = -1;
  bool done = false;
  for (int r = 0; r < k; ++r) {
    float bd = CUDART_INF_F;
    int bi = INT_MAX;
    if (!done) {
      for (int e = tid; e < total; e += blockDim.x) {
        const float dv = d[e];
        if (!(dv < CUDART_INF_F)) continue;
        const int iv = id[e];
        if (lex_less(prev_d, prev_i, dv, iv) && lex_less(dv, iv, bd, bi)) {
          bd = dv;
          bi = iv;
        }
      }
      block_lex_min(bd, bi, sd, si);     // bd is the same in every thread
      if (!(bd < CUDART_INF_F)) done = true;
    }
    if (tid == 0) {
      out_d[r] = done ? CUDART_INF_F : bd;
      out_i[r] = done ? -1 : bi;
    }
    prev_d = bd;
    prev_i = bi;
  }
}

// Pass 2: one block per query merges its nchunks partials of k.
__global__ void __launch_bounds__(256)
scan_merge_kernel(const float* __restrict__ part_d,
                  const int* __restrict__ part_i, int* __restrict__ out_i,
                  float* __restrict__ out_d, int nchunks, int k) {
  __shared__ float sd[32];
  __shared__ int si[32];
  const size_t b = blockIdx.x;
  block_topk(part_d + b * nchunks * k, part_i + b * nchunks * k, nchunks * k,
             k, out_d + b * k, out_i + b * k, sd, si);
}

// Sets rows [s, e) of one lane's bitmap row in words w0, w0 + step, ...:
// whole words stored, the two edge words atomicOr'ed (two windows of a
// lane may share them), and flags their tiles t0, t0 + step, ... in tf
// (tiles of 1 << tsh rows; a flag is read before it is stored, since many
// windows meet one tile).
__device__ __forceinline__ void cover_rows(unsigned* row, unsigned char* tf,
                                           int s, int e, int tsh, int w0,
                                           int t0, int step) {
  for (int w = w0; w <= (e - 1) >> 5; w += step) {
    const int lo = max(s, w << 5), hi = min(e, (w + 1) << 5);
    const int n = hi - lo, sh = lo - (w << 5);
    if (n == 32) row[w] = 0xffffffffu;
    else atomicOr(row + w, ((1u << n) - 1u) << sh);
  }
  for (int t = t0; t <= (e - 1) >> tsh; t += step)
    if (!tf[t]) tf[t] = 1;
}

// The windowed form's pre-pass: thread j reads window j = b * W + w of the
// (B, W) starts/counts and sets its rows [start, start + count), clipped
// to [0, N), in cov[b * nwords + r / 32] (bit r % 32) -- a pad window
// (start < 0 or count <= 0) sets none -- and flags each tile of 1 << tsh
// rows it meets in tflag[(b / BQ) * ntiles + t]. The planner pads each
// lane to W windows, a power of two that reaches 65,536 in served
// batches, and most live windows are a few words long, so a thread sets a
// window of up to 32 words alone, and the warp's lanes share each longer
// one. All in 32-bit arithmetic, tiles by shifts: a 64-bit division is a
// routine of tens of instructions.
__global__ void __launch_bounds__(256)
window_cover_kernel(const int* __restrict__ starts,
                    const int* __restrict__ counts, unsigned* __restrict__ cov,
                    unsigned char* __restrict__ tflag, int BW, int W, int N,
                    int nwords, int ntiles, int tsh) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  int s = 0, e = 0;                                // e = 0: nothing to set
  if (j < BW) {
    s = starts[j];
    const int c = counts[j];
    if (s >= 0 && c > 0 && s < N)
      e = (int)min((long long)s + c, (long long)N);
  }
  const int b = j / W;
  const bool big = e > 0 && ((e - 1) >> 5) - (s >> 5) >= 32;
  if (e > 0 && !big)
    cover_rows(cov + (size_t)b * nwords, tflag + (size_t)(b / BQ) * ntiles,
               s, e, tsh, s >> 5, s >> tsh, 1);
  unsigned live = __ballot_sync(0xffffffffu, big);
  while (live) {
    const int src = __ffs(live) - 1;
    live &= live - 1u;
    const int ws = __shfl_sync(0xffffffffu, s, src);
    const int we = __shfl_sync(0xffffffffu, e, src);
    const int wb = __shfl_sync(0xffffffffu, b, src);
    cover_rows(cov + (size_t)wb * nwords,
               tflag + (size_t)(wb / BQ) * ntiles, ws, we, tsh,
               (ws >> 5) + lane, (ws >> tsh) + lane, 32);
  }
}

// ---- the bitmask scan: compaction, then pass 1 over the passing rows

constexpr int SEG = 8192;                   // mask rows a compaction block owns
constexpr int MQ = 128, MR = 64, MLD = DS + 4;
constexpr int MSTAGE = (MQ + MR) * MLD;     // floats per cp.async stage

__device__ __forceinline__ int block_sum256(int v, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) t += ws[w];
  __syncthreads();
  return t;
}

// blk_count[b] = rows of segment b whose mask value is > 0 (NaN fails).
__global__ void __launch_bounds__(256)
mask_count_kernel(const float* __restrict__ mask, int N,
                  int* __restrict__ blk_count) {
  __shared__ int ws[8];
  const long long r0 = (long long)blockIdx.x * SEG;
  int n = 0;
  for (int i = threadIdx.x; i < SEG; i += 256) {
    const long long r = r0 + i;
    n += (r < N && __ldg(mask + r) > 0.f) ? 1 : 0;
  }
  n = block_sum256(n, ws);
  if (threadIdx.x == 0) blk_count[blockIdx.x] = n;
}

// Writes segment b's passing row ids, ascending, at the sum of the earlier
// segments' counts: per 256 rows a warp ballot, each lane's rank in it, and
// an exclusive prefix over the 8 warps' totals. The last block writes the
// list's length to *count.
__global__ void __launch_bounds__(256)
mask_compact_kernel(const float* __restrict__ mask, int N,
                    const int* __restrict__ blk_count, int nblk,
                    int* __restrict__ list, int* __restrict__ count) {
  __shared__ int ws[8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int base = 0;
  for (int i = tid; i < (int)blockIdx.x; i += 256) base += blk_count[i];
  base = block_sum256(base, ws);
  const long long r0 = (long long)blockIdx.x * SEG;
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = 0; i0 < SEG; i0 += 256) {
    const long long r = r0 + i0 + tid;
    const bool p = r < N && __ldg(mask + r) > 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, p);
    if (lane == 0) ws[warp] = __popc(bal);
    __syncthreads();
    int off = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      off += w < warp ? ws[w] : 0;
      tot += ws[w];
    }
    if (p) list[base + off + __popc(bal & below)] = (int)r;
    base += tot;
    __syncthreads();
  }
  if (blockIdx.x == nblk - 1 && tid == 0) *count = base;
}

// Pass 1 of the bitmask scan over the compacted list: the *count passing
// rows split evenly (in MR-row tiles) over gridDim.y chunks; block (x,
// chunk) takes queries [x * MQ, x * MQ + MQ), so the query tiles of one
// chunk run side by side and read its rows from memory once. Each (query,
// row) distance is the box scan's: one fmaf chain of (q_j - row_j)^2 over
// ascending j. A bf16 corpus's rows come by 16-byte loads (8 elements;
// scalar ones where d % 8 != 0) held in registers across the previous
// step's arithmetic and widened to f32 as they are stored, so the stages
// count elements as f32 words and the inner loop is the f32 one. The
// wide forms' instance (LIST, k = 0) hands each tile's pairs to the
// candidate lists of `ls` instead and, as a sample pass, walks 1 in
// ls.tstride of the list's MR-row tiles (a virtual list of those tiles).
template <typename T, bool VEC, bool LIST>
__device__ __forceinline__ void
mask_partial_body(const T* __restrict__ corpus, const int* __restrict__ list,
                  const int* __restrict__ count_p,
                  const float* __restrict__ q, float* __restrict__ part_d,
                  int* __restrict__ part_i, int B, int d, int k,
                  const ListSink& ls) {
  extern __shared__ float4 msm4[];
  float* msm = reinterpret_cast<float*>(msm4);
  float* Dt = msm + 2 * MSTAGE;             // MQ x (MR + 1) distances
  float* topd = Dt + MQ * (MR + 1);         // MQ*k dists, then MQ*k ids
  int* topi = reinterpret_cast<int*>(topd + MQ * k);

  long long count = *count_p;
  const int ts = LIST ? ls.tstride : 1;     // list tiles a step skips
  if (LIST && ts > 1) {                     // the sampled tiles' rows
    const long long ns = ((count + MR - 1) / MR + ts - 1) / ts;
    count = ns ? (ns - 1) * MR + min((long long)MR, count - (ns - 1) * ts * MR)
               : 0;
  }
  const int nchunks = gridDim.y, chunk = blockIdx.y;
  const int q0 = blockIdx.x * MQ;
  long long per = (count + nchunks - 1) / nchunks;
  per = (per + MR - 1) / MR * MR;
  const long long beg = min(count, chunk * per);
  const long long end = min(count, beg + per);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const float tau = LIST && ls.tau != nullptr && tid < MQ && q0 + tid < B
                        ? ls.tau[q0 + tid] : CUDART_INF_F;

  for (int e = tid; e < MQ * k; e += 256) {
    topd[e] = CUDART_INF_F;
    topi[e] = -1;
  }

  const int nslab = (d + DS - 1) / DS;
  const int ntiles = (int)((end - beg + MR - 1) / MR);
  const int steps = ntiles * nslab;
  constexpr bool F32 = sizeof(T) == 4;
  uint4 raw8 = make_uint4(0u, 0u, 0u, 0u);  // a bf16 row slab in flight
  T raw1[(MR * DS) / 256];
  // stage `s & 1` <- the q slab and the gathered row slab of step s (an
  // f32 slab by cp.async, a bf16 one into registers for `put`)
  auto fetch = [&](int s) {
    const int tile = s / nslab;
    const int k0 = (s - tile * nslab) * DS;
    const long long t0 = beg + (long long)tile * MR;
    // lt[t0 + r]: the row of virtual entry t0 + r
    const int* lt = LIST ? list + t0 / MR * ts * MR - t0 : list;
    float* Qs = msm + (s & 1) * MSTAGE;
    float* Rs = Qs + MQ * MLD;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < (MQ * DS / 4) / 256; ++i) {
        const int e = tid + i * 256;
        const int r = e >> 3, c4 = (e & 7) * 4;
        const int gq = q0 + r, gk = k0 + c4;
        int bytes = min(16, max(0, (d - gk) * 4));
        bytes = gq < B ? bytes : 0;
        cp_async16(Qs + r * MLD + c4,
                   bytes ? q + (size_t)gq * d + gk : q, bytes);
      }
      if constexpr (F32) {
#pragma unroll
        for (int i = 0; i < (MR * DS / 4) / 256; ++i) {
          const int e = tid + i * 256;
          const int r = e >> 3, c4 = (e & 7) * 4;
          const int gk = k0 + c4;
          const int id = t0 + r < end ? __ldg(lt + t0 + r) : -1;
          int bytes = min(16, max(0, (d - gk) * 4));
          bytes = id >= 0 ? bytes : 0;
          cp_async16(Rs + r * MLD + c4,
                     bytes ? corpus + (size_t)id * d + gk : corpus, bytes);
        }
      } else {                        // one 8-element load a thread
        const int r = tid >> 2, c8 = (tid & 3) * 8;
        const int gk = k0 + c8;
        const int id = t0 + r < end ? __ldg(lt + t0 + r) : -1;
        raw8 = (id >= 0 && gk < d)
                   ? __ldg(reinterpret_cast<const uint4*>(
                         corpus + (size_t)id * d + gk))
                   : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < (MQ * DS) / 256; ++i) {
        const int e = tid + i * 256;
        const int r = e >> 5, c = e & 31;
        const int gq = q0 + r, gk = k0 + c;
        const bool in = gq < B && gk < d;
        cp_async4(Qs + r * MLD + c, in ? q + (size_t)gq * d + gk : q,
                  in ? 4 : 0);
      }
#pragma unroll 4
      for (int i = 0; i < (MR * DS) / 256; ++i) {
        const int e = tid + i * 256;
        const int r = e >> 5, c = e & 31;
        const int gk = k0 + c;
        const int id = t0 + r < end ? __ldg(lt + t0 + r) : -1;
        const bool in = id >= 0 && gk < d;
        if constexpr (F32)
          cp_async4(Rs + r * MLD + c,
                    in ? corpus + (size_t)id * d + gk : corpus, in ? 4 : 0);
        else
          raw1[i] = in ? corpus[(size_t)id * d + gk] : zero_of<T>();
      }
    }
  };
  // bf16 rows of step s, from the registers into stage s & 1, widened
  auto put = [&](int s) {
    if constexpr (!F32) {
      float* Rs = msm + (s & 1) * MSTAGE + MQ * MLD;
      if (VEC) {
        const int r = tid >> 2, c8 = (tid & 3) * 8;
        const T* v = reinterpret_cast<const T*>(&raw8);
#pragma unroll
        for (int u = 0; u < 8; u += 4)
          *reinterpret_cast<float4*>(Rs + r * MLD + c8 + u) =
              make_float4(widen(v[u], 0.f), widen(v[u + 1], 0.f),
                          widen(v[u + 2], 0.f), widen(v[u + 3], 0.f));
      } else {
#pragma unroll
        for (int i = 0; i < (MR * DS) / 256; ++i) {
          const int e = tid + i * 256;
          Rs[(e >> 5) * MLD + (e & 31)] = widen(raw1[i], 0.f);
        }
      }
    }
  };

  float acc[8][4];
  if (steps > 0) fetch(0);
  cp_async_commit();
  if (steps > 0) put(0);
  for (int s = 0; s < steps; ++s) {
    const int tile = s / nslab;
    const int sl = s - tile * nslab;
    if (s + 1 < steps) fetch(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (sl == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    const float* Qs = msm + (s & 1) * MSTAGE;
    const float* Rs = Qs + MQ * MLD;
#pragma unroll
    for (int kk = 0; kk < DS; kk += 4) {
      float4 a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * MLD + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(Rs + (tx + 16 * j) * MLD + kk);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = a[i].x - b[j].x;
          acc[i][j] = fmaf(t, t, acc[i][j]);
          t = a[i].y - b[j].y;
          acc[i][j] = fmaf(t, t, acc[i][j]);
          t = a[i].z - b[j].z;
          acc[i][j] = fmaf(t, t, acc[i][j]);
          t = a[i].w - b[j].w;
          acc[i][j] = fmaf(t, t, acc[i][j]);
        }
    }
    if (sl == nslab - 1) {
      const long long t0 = beg + (long long)tile * MR;
      const int nr = (int)min((long long)MR, end - t0);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Dt[(ty + 16 * i) * (MR + 1) + tx + 16 * j] = acc[i][j];
      __syncthreads();
      const int* lt = LIST ? list + t0 / MR * ts * MR - t0 : list;
      if (LIST && tid < MQ && q0 + tid < B) {
        // the pairs within tau: one list reservation for them all
        int n = 0;
        for (int r = 0; r < nr; ++r) {
          const float dv = Dt[tid * (MR + 1) + r];
          n += dv <= tau && dv < CUDART_INF_F;
        }
        if (n > 0) {
          unsigned long long* dst = ls.list + (size_t)(q0 + tid) * ls.cap;
          int j = atomicAdd(ls.count + q0 + tid, n);
          for (int r = 0; r < nr; ++r) {
            const float dv = Dt[tid * (MR + 1) + r];
            if (dv <= tau && dv < CUDART_INF_F) {
              if (j < ls.cap) dst[j] = list_key(dv, __ldg(lt + t0 + r));
              ++j;
            }
          }
        }
      } else if (!LIST && tid < MQ && q0 + tid < B) {
        // ascending row ids; insertion after equal distances keeps the
        // lowest id first, as the box scan's fold
        float* td = topd + tid * k;
        int* ti = topi + tid * k;
        float worst = td[k - 1];
        for (int r = 0; r < nr; ++r) {
          const float dv = Dt[tid * (MR + 1) + r];
          if (dv < worst) {
            int p = k - 1;
            while (p > 0 && td[p - 1] > dv) {
              td[p] = td[p - 1];
              ti[p] = ti[p - 1];
              --p;
            }
            td[p] = dv;
            ti[p] = __ldg(lt + t0 + r);
            worst = td[k - 1];
          }
        }
      }
    }
    if (s + 1 < steps) put(s + 1);    // stage (s + 1) & 1 is idle here
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  if constexpr (!LIST)
    for (int e = tid; e < MQ * k; e += 256) {
      const int gq = q0 + e / k;
      if (gq < B) {
        const size_t o = ((size_t)gq * nchunks + chunk) * k + (e % k);
        part_d[o] = topd[e];
        part_i[o] = topi[e];
      }
    }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
mask_partial_kernel(const T* __restrict__ corpus,
                    const int* __restrict__ list,
                    const int* __restrict__ count_p,
                    const float* __restrict__ q, float* __restrict__ part_d,
                    int* __restrict__ part_i, int B, int d, int k) {
  mask_partial_body<T, VEC, false>(corpus, list, count_p, q, part_d, part_i,
                                   B, d, k, ListSink{});
}

// The wide forms' bitmask pass (scan_topk_wide.cu): mask_partial_body's
// scoring into the candidate lists; shared memory as k = 0.
template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
mask_list_kernel(const T* __restrict__ corpus, const int* __restrict__ list,
                 const int* __restrict__ count_p, const float* __restrict__ q,
                 int B, int d, ListSink ls) {
  mask_partial_body<T, VEC, true>(corpus, list, count_p, q, nullptr, nullptr,
                                  B, d, 0, ls);
}

#ifndef SCAN_TOPK_DEVICE_ONLY
template <typename T, bool WIN>
int launch(const void* corpus, const void* scale, const void* attrs,
           const void* q, const void* qlo, const void* qhi, const void* cov,
           void* part_d, void* part_i, void* sched, void* out_i, void* out_d,
           int B, int N, int d, int m, int k, int tr, int blocks, int smem,
           void* stream) {
  if (B == 0) return 0;
  if (k < 1 || k > KMAX || m < 1 || m > MMAX || N < 1 || blocks < 1 ||
      (tr != 64 && tr != 128 && tr != 256) ||
      smem != box_scan_smem_words(tr, k) * (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  const int qblocks = (B + BQ - 1) / BQ;
  if (qblocks > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  // the tile counters, the windowed form's uncovered count and the
  // (empty, sparse, dense) tile counts
  cudaError_t e = cudaMemsetAsync(sched, 0, (qblocks + 3 + WIN) * sizeof(int),
                                  s);
  if (e != cudaSuccess) return (int)e;
  const bool vec = d % Vec<T>::V == 0 && ((uintptr_t)corpus & 15) == 0 &&
                   ((uintptr_t)q & 15) == 0;
  auto kern = vec ? box_scan_kernel<T, true, WIN>
                  : box_scan_kernel<T, false, WIN>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(blocks, qblocks), BT, smem, s>>>(
      (const T*)corpus, (const float*)scale, (const float*)attrs,
      (const float*)q, (const float*)qlo, (const float*)qhi,
      (const unsigned*)cov, (float*)part_d, (int*)part_i, (int*)sched, B, N,
      d, m, k, tr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_merge_kernel<<<B, 256, 0, s>>>((const float*)part_d,
                                      (const int*)part_i, (int*)out_i,
                                      (float*)out_d, blocks, k);
  return (int)cudaGetLastError();
}
#endif  // SCAN_TOPK_DEVICE_ONLY

}  // namespace

// scan_topk_wide.cu includes this file for its kernels alone
#ifndef SCAN_TOPK_DEVICE_ONLY

// One entry per form. `side` is the int8 (q8) entry's per-row scale, the
// windowed entry's coverage (window_cover's, at the same B, N and tr:
// the scan reads only the rows it marks, and returns positions), null
// for the others. part_d/part_i hold B * blocks * k entries, sched
// ceil(B / 256) + 3 ints (+ 4 for the windowed form); smem is
// ops._scan_plan's, which must equal box_scan_smem_words(tr, k) * 4.
#define SCAN_ENTRY(NAME, T, WIN)                                             \
  extern "C" int NAME(const void* corpus, const void* side,                  \
                      const void* attrs, const void* q, const void* qlo,     \
                      const void* qhi, void* part_d, void* part_i,           \
                      void* sched, void* out_i, void* out_d, int B, int N,   \
                      int d, int m, int k, int tr, int blocks, int smem,     \
                      void* stream) {                                        \
    return launch<T, WIN>(corpus, WIN ? nullptr : side, attrs, q, qlo, qhi,  \
                          WIN ? side : nullptr, part_d, part_i, sched,       \
                          out_i, out_d, B, N, d, m, k, tr, blocks, smem,     \
                          stream);                                           \
  }

SCAN_ENTRY(scan_topk_f32, float, false)
SCAN_ENTRY(scan_topk_bf16, __nv_bfloat16, false)
SCAN_ENTRY(scan_topk_q8, int8_t, false)
SCAN_ENTRY(scan_topk_windows_f32, float, true)
SCAN_ENTRY(scan_topk_windows_bf16, __nv_bfloat16, true)

namespace {

template <typename T>
int launch_mask(const void* corpus, const void* mask, const void* q,
                void* scratch, void* part_d, void* part_i, void* out_i,
                void* out_d, int B, int N, int d, int k, int nchunks,
                void* stream) {
  if (B == 0) return 0;
  if (k < 1 || k > KMAX || N < 1 || nchunks < 1)
    return (int)cudaErrorInvalidValue;
  if (nchunks > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = (N + SEG - 1) / SEG;
  int* list = (int*)scratch;
  int* blk_count = list + N;
  int* count = blk_count + nblk;
  mask_count_kernel<<<nblk, 256, 0, s>>>((const float*)mask, N, blk_count);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mask_compact_kernel<<<nblk, 256, 0, s>>>((const float*)mask, N, blk_count,
                                           nblk, list, count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const bool vec = d % Vec<T>::V == 0 && ((uintptr_t)corpus & 15) == 0 &&
                   ((uintptr_t)q & 15) == 0;
  auto kern = vec ? mask_partial_kernel<T, true>
                  : mask_partial_kernel<T, false>;
  const int smem = (2 * MSTAGE + MQ * (MR + 1)) * (int)sizeof(float) +
                   MQ * k * (int)(sizeof(float) + sizeof(int));
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid1((B + MQ - 1) / MQ, nchunks);
  kern<<<grid1, 256, smem, s>>>((const T*)corpus, list, count,
                                (const float*)q, (float*)part_d,
                                (int*)part_i, B, d, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_merge_kernel<<<B, 256, 0, s>>>((const float*)part_d,
                                      (const int*)part_i, (int*)out_i,
                                      (float*)out_d, nchunks, k);
  return (int)cudaGetLastError();
}

}  // namespace

// The bitmask scan over an f32 corpus or its bf16 form: mask (N) f32, > 0
// passes (NaN fails). scratch holds 2 * N + 1 ints, enough for any SEG:
// the compacted list (N), the per-segment counts (ceil(N / SEG)) and the
// list's length. part_d/part_i hold B * nchunks * k entries.
#define MASK_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* corpus, const void* mask, const void* q,  \
                      void* scratch, void* part_d, void* part_i,             \
                      void* out_i, void* out_d, int B, int N, int d, int k,  \
                      int nchunks, void* stream) {                           \
    return launch_mask<T>(corpus, mask, q, scratch, part_d, part_i, out_i,   \
                          out_d, B, N, d, k, nchunks, stream);               \
  }

MASK_ENTRY(scan_topk_mask_f32, float)
MASK_ENTRY(scan_topk_mask_bf16, __nv_bfloat16)

// The windowed scan's coverage over N rows and tr-row tiles: starts/counts
// (B, W) int32; cover holds B * ceil(N / 32) words of bitmap, then
// ceil(B / 256) * ceil(N / tr) bytes of tile flags. Zeroes it, then sets
// each live window's rows and tiles.
extern "C" int window_cover(const void* starts, const void* counts,
                            void* cover, int B, int W, int N, int tr,
                            void* stream) {
  if (B == 0) return 0;
  if (W < 1 || N < 1 || N > INT_MAX - 32 || tr < 1 || (tr & (tr - 1)))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * W > INT_MAX - 255)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const int nwords = (N + 31) / 32, ntiles = (N + tr - 1) / tr;
  const size_t qblocks = (B + BQ - 1) / BQ;
  unsigned* cov = (unsigned*)cover;
  unsigned char* tflag = (unsigned char*)(cov + (size_t)B * nwords);
  cudaError_t e = cudaMemsetAsync(
      cover, 0, (size_t)B * nwords * sizeof(unsigned) + qblocks * ntiles, s);
  if (e != cudaSuccess) return (int)e;
  const int BW = B * W;
  window_cover_kernel<<<(BW + 255) / 256, 256, 0, s>>>(
      (const int*)starts, (const int*)counts, cov, tflag, BW, W, N, nwords,
      ntiles, __builtin_ctz(tr));
  return (int)cudaGetLastError();
}
#endif  // SCAN_TOPK_DEVICE_ONLY
