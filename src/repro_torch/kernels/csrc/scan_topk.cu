// Exact predicate-masked brute scan with a top-k, for Hopper (sm_90a), over
// an f32 corpus, its bf16 replica or its int8 replica; its bitmask form; and
// its windowed form over a position-ordered corpus.
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
// Bound on the H100: it depends on the boxes. Reading the corpus and
// attrs once is ~3.1 GB at N=1M, d=768 in f32 (~0.92 ms at 3.35 TB/s),
// ~1.55 GB in bf16 (~0.46 ms) and ~0.79 GB in int8 (~0.24 ms). Only
// (query, row) pairs whose row passes the box need a distance, 3 flops
// per dimension (sub + fma): with every pair passing that is 5.9e11 flop
// at B=256, ~8.8 ms at 67 TFLOP/s fp32, but with the planner's scan
// lanes (boxes under 10% of N) it is under 0.9 ms, so the bound is the
// bytes. chip_smoke.py computes it from its own boxes. This design reads
// the corpus once per 64-query tile, and computes every pair of a row
// tile in which any pair passes. The bitmask form needs a distance only
// for the rows its mask passes, for every query: 3 flops per (pair,
// dimension) make 4.75 ms at 67 TFLOP/s for chip_smoke.py's 539,333
// passing rows x 256 queries x 768, the bound; the direct form needs two
// fp32 instructions (sub, fma) per (pair, dimension), 2.12e11 there: 6.3
// ms at one instruction a lane a cycle is its ceiling. The windowed form
// reads, per lane, the attrs of every row its windows cover and the
// vector of each such row that passes the box (the TPU kernel reads every
// covered vector): its bound is covered rows x m x 4 + passing rows x d x
// 4 bytes, each row a one-query dot product, so it is bound by bytes.
//
// Design: on the TPU the grid walks N in order and carries the running
// top-k from step to step. H100 blocks run in no order, so this is two
// passes:
//   pass 1 (scan_partial_kernel): a block owns a tile of QT=64 queries and
//     a chunk of rows. It walks the chunk in 64-row tiles: the tile's attrs
//     are tested against the 64 boxes first (a tile with
//     no passing pair skips its distance work), then distances come from a
//     shared-memory tiled SIMT loop over 32-wide d slabs (a bf16 or int8
//     slab is widened to f32, and an int8 one scaled, while it is staged
//     into shared memory, so the inner loop is the f32 one) with a 4x4
//     register tile per thread, and one thread per query folds the masked
//     tile into that query's running top-k (insertion after equal
//     distances, so ascending row order keeps the lowest id first). Each
//     chunk writes its partial top-k.
//   pass 2 (scan_merge_kernel): one block per query merges the chunk
//     partials by (distance, id) in k rounds of a block-wide arg-min.
// The wrapper picks the chunk count so pass 1 fills the card; it allocates
// the partial buffers and the outputs.
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
// ties are the box scan's bit for bit on the same rows; the fold into the
// per-query top-k and pass 2 are the box scan's.
//
// The windowed form (windows_partial_kernel) has one block per (lane,
// window, chunk of at most `chunk_rows` rows), so a 100k-row window is not
// serialised: the wrapper lays the items out by an inclusive prefix sum of
// each window's chunk count, and a block finds its window by binary search
// in it. A block reads only the rows of its chunk that lie inside the
// window (no padding past a window's count, unlike the TPU kernel's fixed
// (w_cap, d) DMA), one warp per row: the attrs first, then the distance
// with the lanes striding over d and a shuffle sum. The block keeps its
// chunk's top-k by (distance, position) in k rounds of a block arg-min,
// and pass 2 merges each lane's items, whose range the wrapper gives as
// per-lane offsets. Positions are unique, so the (distance, position)
// order is the reference's tie order whatever order the blocks ran in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int QT = 64, TR = 64, DS = 32, MMAX = 8, KMAX = 64;

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

__device__ __forceinline__ float widen(float v, const float*, int) {
  return v;
}
__device__ __forceinline__ float widen(__nv_bfloat16 v, const float*, int) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v, const float* scale, int r) {
  return __fmul_rn(static_cast<float>(v), __ldg(scale + r));
}

template <typename T>
__global__ void __launch_bounds__(256)
scan_partial_kernel(const T* __restrict__ corpus,
                    const float* __restrict__ scale,
                    const float* __restrict__ attrs,
                    const float* __restrict__ q,
                    const float* __restrict__ qlo,
                    const float* __restrict__ qhi,
                    float* __restrict__ part_d, int* __restrict__ part_i,
                    int B, int N, int d, int m, int k, int chunk_rows,
                    int nchunks) {
  __shared__ float Qs[DS][QT + 1];
  __shared__ float Rs[DS][TR + 1];
  __shared__ float Dt[QT][TR + 1];
  __shared__ float Ra[TR][MMAX];
  __shared__ float QL[QT][MMAX];
  __shared__ float QH[QT][MMAX];
  extern __shared__ float topd[];          // QT*k dists, then QT*k ids
  int* topi = reinterpret_cast<int*>(topd + QT * k);

  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int r_begin = chunk * chunk_rows;
  const int r_end = min(N, r_begin + chunk_rows);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  for (int e = tid; e < QT * m; e += 256) {
    const int qi = e / m, a = e % m;
    const int gq = q0 + qi;
    // queries past B get the empty box: no row ever passes
    QL[qi][a] = gq < B ? qlo[(size_t)gq * m + a] : CUDART_INF_F;
    QH[qi][a] = gq < B ? qhi[(size_t)gq * m + a] : -CUDART_INF_F;
  }
  for (int e = tid; e < QT * k; e += 256) {
    topd[e] = CUDART_INF_F;
    topi[e] = -1;
  }
  __syncthreads();

  for (int r0 = r_begin; r0 < r_end; r0 += TR) {
    for (int e = tid; e < TR * m; e += 256) {
      const int r = e / m, a = e % m;
      const int gr = r0 + r;
      Ra[r][a] = gr < r_end ? attrs[(size_t)gr * m + a] : CUDART_NAN_F;
    }
    __syncthreads();

    unsigned pass = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = ty + 16 * i, rj = tx + 16 * j;
        bool ok = true;
        for (int a = 0; a < m; ++a) {
          const float v = Ra[rj][a];
          ok = ok && (v >= QL[qi][a]) && (v <= QH[qi][a]);
        }
        pass |= (ok ? 1u : 0u) << (i * 4 + j);
      }
    const int any = __syncthreads_or(pass != 0u);

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if (any) {
      for (int k0 = 0; k0 < d; k0 += DS) {
#pragma unroll
        for (int s = 0; s < (QT * DS) / 256; ++s) {
          const int e = tid + s * 256;
          const int r = e / DS, col = e % DS;
          const int gk = k0 + col;
          const int gq = q0 + r, gr = r0 + r;
          Qs[col][r] = (gq < B && gk < d) ? q[(size_t)gq * d + gk] : 0.f;
          Rs[col][r] = (gr < r_end && gk < d)
                           ? widen(corpus[(size_t)gr * d + gk], scale, gr)
                           : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < DS; ++kk) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = Qs[kk][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = Rs[kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float t = a[i] - b[j];
              acc[i][j] = fmaf(t, t, acc[i][j]);
            }
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Dt[ty + 16 * i][tx + 16 * j] =
            ((pass >> (i * 4 + j)) & 1u) ? acc[i][j] : CUDART_INF_F;
    __syncthreads();

    if (tid < QT && q0 + tid < B) {
      float* td = topd + tid * k;
      int* ti = topi + tid * k;
      float worst = td[k - 1];
      const int nr = min(TR, r_end - r0);
      for (int r = 0; r < nr; ++r) {
        const float dv = Dt[tid][r];
        if (dv < worst) {
          int p = k - 1;
          while (p > 0 && td[p - 1] > dv) {
            td[p] = td[p - 1];
            ti[p] = ti[p - 1];
            --p;
          }
          td[p] = dv;
          ti[p] = r0 + r;
          worst = td[k - 1];
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < QT * k; e += 256) {
    const int gq = q0 + e / k;
    if (gq < B) {
      const size_t o = ((size_t)gq * nchunks + chunk) * k + (e % k);
      part_d[o] = topd[e];
      part_i[o] = topi[e];
    }
  }
}

__device__ __forceinline__ bool lex_less(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
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
// `id` null means id[e] = id0 + e.
__device__ void block_topk(const float* d, const int* id, int id0, int total,
                           int k, float* out_d, int* out_i, float* sd,
                           int* si) {
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
        const int iv = id ? id[e] : id0 + e;
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

// Pass 2: one block per query merges its partials. With lane_off null
// query b owns nchunks partials of k; else it owns partials
// [lane_off[b], lane_off[b + 1]).
__global__ void __launch_bounds__(256)
scan_merge_kernel(const float* __restrict__ part_d,
                  const int* __restrict__ part_i,
                  const int* __restrict__ lane_off, int* __restrict__ out_i,
                  float* __restrict__ out_d, int nchunks, int k) {
  __shared__ float sd[32];
  __shared__ int si[32];
  const int b = blockIdx.x;
  const size_t begin = lane_off ? (size_t)lane_off[b] : (size_t)b * nchunks;
  const int total =
      (lane_off ? lane_off[b + 1] - lane_off[b] : nchunks) * k;
  block_topk(part_d + begin * k, part_i + begin * k, 0, total, k,
             out_d + (size_t)b * k, out_i + (size_t)b * k, sd, si);
}

// Windowed pass 1: block `item` owns chunk c of window j = (lane b, w),
// where offs (B*W, inclusive prefix sum of each live window's chunk count)
// gives offs[j-1] <= item < offs[j]. Writes that chunk's top-k positions.
__global__ void __launch_bounds__(256)
windows_partial_kernel(const float* __restrict__ corpus,
                       const float* __restrict__ attrs,
                       const float* __restrict__ q,
                       const float* __restrict__ qlo,
                       const float* __restrict__ qhi,
                       const int* __restrict__ starts,
                       const int* __restrict__ counts,
                       const int* __restrict__ offs,
                       float* __restrict__ part_d, int* __restrict__ part_i,
                       int BW, int W, int N, int d, int m, int k,
                       int chunk_rows) {
  extern __shared__ float wsm[];
  float* qs = wsm;                          // the lane's query, d floats
  float* Dt = wsm + d;                      // chunk_rows distances
  __shared__ float QL[MMAX], QH[MMAX];
  __shared__ float sd[32];
  __shared__ int si[32];
  const int item = blockIdx.x;
  int lo = 0, hi = BW - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offs[mid] > item) hi = mid; else lo = mid + 1;
  }
  const int j = lo, b = j / W;
  const int cnt = counts[j];
  const int nch = (cnt + chunk_rows - 1) / chunk_rows;
  const long long r0 = (long long)starts[j] +
                       (long long)(item - (offs[j] - nch)) * chunk_rows;
  long long r1 = (long long)starts[j] + cnt;
  if (r1 > N) r1 = N;                       // rows past N do not exist
  if (r1 > r0 + chunk_rows) r1 = r0 + chunk_rows;
  const int nr = r1 > r0 ? (int)(r1 - r0) : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int e = tid; e < d; e += blockDim.x) qs[e] = q[(size_t)b * d + e];
  if (tid < m) {
    QL[tid] = qlo[(size_t)b * m + tid];
    QH[tid] = qhi[(size_t)b * m + tid];
  }
  __syncthreads();
  for (int r = warp; r < nr; r += nwarps) {
    const size_t row = (size_t)(r0 + r);
    bool ok = true;
    for (int a = 0; a < m; ++a) {
      const float v = __ldg(attrs + row * m + a);
      ok = ok && (v >= QL[a]) && (v <= QH[a]);
    }
    float dv = CUDART_INF_F;
    if (ok) {                               // the same in every lane
      const float* x = corpus + row * d;
      float acc = 0.f;
#pragma unroll 4
      for (int e = lane; e < d; e += 32) {
        const float t = qs[e] - __ldg(x + e);
        acc = fmaf(t, t, acc);
      }
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      dv = acc;
    }
    if (lane == 0) Dt[r] = dv;
  }
  __syncthreads();
  block_topk(Dt, nullptr, (int)r0, nr, k, part_d + (size_t)item * k,
             part_i + (size_t)item * k, sd, si);
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
// ascending j.
template <bool VEC>
__global__ void __launch_bounds__(256)
mask_partial_kernel(const float* __restrict__ corpus,
                    const int* __restrict__ list,
                    const int* __restrict__ count_p,
                    const float* __restrict__ q, float* __restrict__ part_d,
                    int* __restrict__ part_i, int B, int d, int k) {
  extern __shared__ float4 msm4[];
  float* msm = reinterpret_cast<float*>(msm4);
  float* Dt = msm + 2 * MSTAGE;             // MQ x (MR + 1) distances
  float* topd = Dt + MQ * (MR + 1);         // MQ*k dists, then MQ*k ids
  int* topi = reinterpret_cast<int*>(topd + MQ * k);

  const int count = *count_p;
  const int nchunks = gridDim.y, chunk = blockIdx.y;
  const int q0 = blockIdx.x * MQ;
  long long per = ((long long)count + nchunks - 1) / nchunks;
  per = (per + MR - 1) / MR * MR;
  const long long beg = min((long long)count, chunk * per);
  const long long end = min((long long)count, beg + per);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  for (int e = tid; e < MQ * k; e += 256) {
    topd[e] = CUDART_INF_F;
    topi[e] = -1;
  }

  const int nslab = (d + DS - 1) / DS;
  const int ntiles = (int)((end - beg + MR - 1) / MR);
  const int steps = ntiles * nslab;
  // stage `s & 1` <- the q slab and the gathered row slab of step s
  auto fetch = [&](int s) {
    const int tile = s / nslab;
    const int k0 = (s - tile * nslab) * DS;
    const long long t0 = beg + (long long)tile * MR;
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
#pragma unroll
      for (int i = 0; i < (MR * DS / 4) / 256; ++i) {
        const int e = tid + i * 256;
        const int r = e >> 3, c4 = (e & 7) * 4;
        const int gk = k0 + c4;
        const int id = t0 + r < end ? __ldg(list + t0 + r) : -1;
        int bytes = min(16, max(0, (d - gk) * 4));
        bytes = id >= 0 ? bytes : 0;
        cp_async16(Rs + r * MLD + c4,
                   bytes ? corpus + (size_t)id * d + gk : corpus, bytes);
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
        const int id = t0 + r < end ? __ldg(list + t0 + r) : -1;
        const bool in = id >= 0 && gk < d;
        cp_async4(Rs + r * MLD + c, in ? corpus + (size_t)id * d + gk : corpus,
                  in ? 4 : 0);
      }
    }
  };

  float acc[8][4];
  if (steps > 0) fetch(0);
  cp_async_commit();
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
      if (tid < MQ && q0 + tid < B) {
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
            ti[p] = __ldg(list + t0 + r);
            worst = td[k - 1];
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int e = tid; e < MQ * k; e += 256) {
    const int gq = q0 + e / k;
    if (gq < B) {
      const size_t o = ((size_t)gq * nchunks + chunk) * k + (e % k);
      part_d[o] = topd[e];
      part_i[o] = topi[e];
    }
  }
}

template <typename T>
int launch(const void* corpus, const void* scale, const void* attrs,
           const void* q, const void* qlo, const void* qhi, void* part_d,
           void* part_i, void* out_i, void* out_d, int B, int N, int d,
           int m, int k, int chunk_rows, int nchunks, void* stream) {
  if (B == 0) return 0;
  if (k < 1 || k > KMAX || m < 1 || m > MMAX || N < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = QT * k * (int)(sizeof(float) + sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      scan_partial_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid1(nchunks, (B + QT - 1) / QT);
  scan_partial_kernel<T><<<grid1, 256, smem, s>>>(
      (const T*)corpus, (const float*)scale, (const float*)attrs,
      (const float*)q, (const float*)qlo, (const float*)qhi, (float*)part_d,
      (int*)part_i, B, N, d, m, k, chunk_rows, nchunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_merge_kernel<<<B, 256, 0, s>>>((const float*)part_d,
                                      (const int*)part_i, nullptr,
                                      (int*)out_i, (float*)out_d, nchunks,
                                      k);
  return (int)cudaGetLastError();
}

}  // namespace

// One entry per corpus kind. `scale` is read only by the int8 (q8) entry;
// the others take a null pointer.
#define SCAN_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* corpus, const void* scale,                 \
                      const void* attrs, const void* q, const void* qlo,     \
                      const void* qhi, void* part_d, void* part_i,           \
                      void* out_i, void* out_d, int B, int N, int d, int m,  \
                      int k, int chunk_rows, int nchunks, void* stream) {    \
    return launch<T>(corpus, scale, attrs, q, qlo, qhi, part_d, part_i,      \
                     out_i, out_d, B, N, d, m, k, chunk_rows, nchunks,       \
                     stream);                                                \
  }

SCAN_ENTRY(scan_topk_f32, float)
SCAN_ENTRY(scan_topk_bf16, __nv_bfloat16)
SCAN_ENTRY(scan_topk_q8, int8_t)

// The bitmask scan over an f32 corpus: mask (N) f32, > 0 passes (NaN
// fails). scratch holds 2 * N + 1 ints, enough for any SEG: the compacted
// list (N), the per-segment counts (ceil(N / SEG)) and the list's length. part_d/part_i hold
// B * nchunks * k entries.
extern "C" int scan_topk_mask_f32(const void* corpus, const void* mask,
                                  const void* q, void* scratch, void* part_d,
                                  void* part_i, void* out_i, void* out_d,
                                  int B, int N, int d, int k, int nchunks,
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
  const bool vec = d % 4 == 0 && ((uintptr_t)corpus & 15) == 0 &&
                   ((uintptr_t)q & 15) == 0;
  auto kern = vec ? mask_partial_kernel<true> : mask_partial_kernel<false>;
  const int smem = (2 * MSTAGE + MQ * (MR + 1)) * (int)sizeof(float) +
                   MQ * k * (int)(sizeof(float) + sizeof(int));
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid1((B + MQ - 1) / MQ, nchunks);
  kern<<<grid1, 256, smem, s>>>((const float*)corpus, list, count,
                                (const float*)q, (float*)part_d,
                                (int*)part_i, B, d, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_merge_kernel<<<B, 256, 0, s>>>((const float*)part_d,
                                      (const int*)part_i, nullptr,
                                      (int*)out_i, (float*)out_d, nchunks,
                                      k);
  return (int)cudaGetLastError();
}

// The windowed scan over a position-ordered f32 corpus. starts/counts are
// (B, W); offs (B*W) is the inclusive prefix sum of each window's chunk
// count (0 for a pad window: start < 0 or count <= 0), lane_off (B+1) the
// items each lane starts at, `items` = offs[B*W-1]; part_d/part_i hold
// items * k entries. Outputs are positions.
extern "C" int scan_topk_windows_f32(
    const void* corpus, const void* attrs, const void* q, const void* qlo,
    const void* qhi, const void* starts, const void* counts, const void* offs,
    const void* lane_off, void* part_d, void* part_i, void* out_i,
    void* out_d, int B, int W, int N, int d, int m, int k, int chunk_rows,
    int items, void* stream) {
  if (B == 0) return 0;
  if (k < 1 || k > KMAX || m < 1 || m > MMAX || N < 1 || W < 1 ||
      chunk_rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (items > 0) {
    const int smem = (d + chunk_rows) * (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        windows_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    windows_partial_kernel<<<items, 256, smem, s>>>(
        (const float*)corpus, (const float*)attrs, (const float*)q,
        (const float*)qlo, (const float*)qhi, (const int*)starts,
        (const int*)counts, (const int*)offs, (float*)part_d, (int*)part_i,
        B * W, W, N, d, m, k, chunk_rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  scan_merge_kernel<<<B, 256, 0, s>>>((const float*)part_d,
                                      (const int*)part_i,
                                      (const int*)lane_off, (int*)out_i,
                                      (float*)out_d, 0, k);
  return (int)cudaGetLastError();
}
