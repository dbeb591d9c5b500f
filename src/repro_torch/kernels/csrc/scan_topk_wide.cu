// The scan family's wide form, for Hopper (sm_90a): the exact
// predicate-masked top-k of scan_topk.cu for any 1 <= k <= N and any
// number of attributes m >= 1, where scan_topk.cu's kernels hold each
// query's running top-k in shared memory and so take k <= 64 and m <= 8.
// Its forms: the box scan over an f32, bf16 or int8 corpus, the windowed
// scan over an f32 or bf16 position-ordered corpus (the coverage bitmap
// comes from scan_topk.cu's window_cover), and the bitmask scan over an
// f32 or bf16 corpus.
//
// Replaces: src/repro/kernels/scan_topk.py:scan_topk_kernel (and its bf16
// use), src/repro/kernels/scan_topk.py:scan_topk_q8_kernel,
// src/repro/kernels/scan_topk.py:scan_topk_windows_kernel and
// src/repro/kernels/scan_topk.py:scan_topk_mask_kernel, for the k and m
// that scan_topk.cu's kernels do not take. The reference's kernels check
// only 1 <= k <= N; so does this one.
//
// Computes what scan_topk.cu computes: per query b, the k rows with the
// smallest sum_j (q[b,j] - row(r)[j])^2 among the rows that pass (the box
// all(qlo[b] <= a <= qhi[b]), NaN failing; and, windowed, inside one of
// the lane's windows; or, bitmask, mask[r] > 0), ascending by (distance,
// row id) -- ties to the lowest id, as lax.top_k -- and (-1, +inf) past
// the passing count. Each distance is scan_topk.cu's one fmaf chain
// acc = fmaf(q_j - row_j, q_j - row_j, acc) over ascending j (zero-padded
// past d, which adds exact zeros), so a wide form's distances are the
// narrow form's bit for bit on the same rows.
//
// Design: two kernels a chunk of queries (the wrapper sizes the chunk so
// its scratch stays near 1 GiB: all 256 queries of a served batch at
// N = 1M):
//   wide_score_kernel: a block of 256 threads owns a tile of 64 queries x
//     64 rows, each thread 4 x 4 (query, row) pairs. It tests the pairs'
//     predicates first -- the attrs staged 8 at a time, so any m -- and a
//     tile with no passing pair reads no corpus row; otherwise the tile's
//     queries and rows stream through shared memory in 32-wide d slabs
//     and every pair is computed. It writes the (query, row) distance, or
//     +inf where the pair fails, to a (chunk, N) f32 plane in device
//     memory.
//   wide_select_kernel: a block of 512 threads a query. A radix select
//     over the row's float bits (non-negative floats order as their bits)
//     finds the k-th smallest finite distance in 4 passes of 8 bits, each
//     a histogram in shared memory (warp-aggregated atomics: the top bits
//     of similar distances fall in one bin); a compaction in ascending row
//     order (ballots, a prefix over the warps) keeps the rows below it and
//     the lowest-id rows equal to it, k in all; a stable LSD radix sort of
//     those k (4 passes of 8 bits, stable by warp match and a prefix over
//     the warps) orders them by distance, and since they entered in row
//     order, equal distances stay lowest id first. No library sort or
//     top-k is used.
//
// Bound on the H100: as scan_topk.cu's, reading the corpus and attrs once
// per query chunk (~3.1 GB f32, ~1.55 GB bf16, ~0.79 GB int8 at N = 1M,
// d = 768) against 3 flops per (passing pair, dimension) at 67 TFLOP/s.
// This first design does more: it computes every pair of a tile that has
// one passing pair (2 fp32 instructions a pair and dimension: ~12 ms of
// fp32 issue at B = 256, N = 1M, d = 768 with every tile live), writes
// and re-reads the (chunk, N) plane 5 times (~6 GB at that shape) and
// reads the corpus once per 64 queries. chip_smoke.py times it beside its
// bound; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int WQ = 64, WR = 64;      // queries and rows of a score tile
constexpr int WT = 256;              // threads of a score block
constexpr int WD = 32;               // d-slab width
constexpr int WLD = WD + 4;          // staged stride: float4 loads of 8
                                     // consecutive rows hit 8 bank groups
constexpr int AG = 8;                // attributes staged at a time
constexpr int ST = 512;              // threads of a select block
constexpr int SW = ST / 32;          // its warps
constexpr unsigned INF_BITS = 0x7f800000u;

enum Mode { BOX = 0, WIN = 1, MASK = 2 };

__device__ __forceinline__ float widen(float v, float) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v, float) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v, float s) {
  return __fmul_rn(static_cast<float>(v), s);   // never fused into q - row
}

// Grid (ceil(N / WR), ceil(B / WQ)). Writes dist[b * N + r] for the tile's
// queries b < B and rows r < N: the pair's distance where it passes, else
// +inf. `side` is the int8 form's per-row scale, the windowed form's
// (B, ceil(N / 32)) coverage bitmap, the bitmask form's (N) mask; the
// bitmask form reads no attrs or boxes.
template <typename T, int MODE>
__global__ void __launch_bounds__(WT)
wide_score_kernel(const T* __restrict__ corpus, const void* __restrict__ side,
                  const float* __restrict__ attrs, const float* __restrict__ q,
                  const float* __restrict__ qlo, const float* __restrict__ qhi,
                  float* __restrict__ dist, int B, int N, int d, int m) {
  __shared__ __align__(16) float Qs[WQ * WLD];
  __shared__ __align__(16) float Rs[WR * WLD];
  __shared__ float At[WR * (AG + 1)];
  __shared__ float Lo[WQ * (AG + 1)];
  __shared__ float Hi[WQ * (AG + 1)];

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long r0 = (long long)blockIdx.x * WR;
  const int b0 = blockIdx.y * WQ;
  const int nr = (int)min((long long)WR, (long long)N - r0);
  const int nq = min(WQ, B - b0);

  // bit 4 i + j: the pair (query ty + 16 i, row tx + 16 j) passes
  unsigned ok = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ty + 16 * i < nq && tx + 16 * j < nr) ok |= 1u << (4 * i + j);

  if constexpr (MODE == MASK) {
    const float* mask = static_cast<const float*>(side);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (tx + 16 * j < nr && !(mask[r0 + tx + 16 * j] > 0.f))
        ok &= ~(0x1111u << j);
  } else {
    for (int a0 = 0; a0 < m; a0 += AG) {
      const int na = min(AG, m - a0);
      for (int e = tid; e < WR * AG; e += WT) {
        const int r = e / AG, a = e % AG;
        At[r * (AG + 1) + a] =
            r < nr && a < na ? attrs[(r0 + r) * m + a0 + a] : 0.f;
      }
      for (int e = tid; e < WQ * AG; e += WT) {
        const int i = e / AG, a = e % AG;
        const bool in = i < nq && a < na;
        Lo[i * (AG + 1) + a] = in ? qlo[(size_t)(b0 + i) * m + a0 + a] : 0.f;
        Hi[i * (AG + 1) + a] = in ? qhi[(size_t)(b0 + i) * m + a0 + a] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned bit = 1u << (4 * i + j);
          if (ok & bit) {
            const float* x = At + (tx + 16 * j) * (AG + 1);
            const float* lo = Lo + (ty + 16 * i) * (AG + 1);
            const float* hi = Hi + (ty + 16 * i) * (AG + 1);
            bool p = true;
            for (int a = 0; a < na; ++a)
              p = p & (x[a] >= lo[a]) & (x[a] <= hi[a]);
            if (!p) ok &= ~bit;
          }
        }
      __syncthreads();
    }
    if constexpr (MODE == WIN) {       // only the rows the lane covers
      const unsigned* cov = static_cast<const unsigned*>(side);
      const int nwords = (N + 31) >> 5;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned bit = 1u << (4 * i + j);
          if (ok & bit) {
            const long long r = r0 + tx + 16 * j;
            const unsigned w =
                cov[(size_t)(b0 + ty + 16 * i) * nwords + (r >> 5)];
            if (!((w >> (r & 31)) & 1u)) ok &= ~bit;
          }
        }
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (__syncthreads_or(ok != 0u)) {    // a tile no pair passes reads no row
    const float* scale = static_cast<const float*>(side);
    for (int k0 = 0; k0 < d; k0 += WD) {
      for (int e = tid; e < WQ * WD; e += WT) {
        const int i = e / WD, c = e % WD, gk = k0 + c;
        Qs[i * WLD + c] =
            i < nq && gk < d ? q[(size_t)(b0 + i) * d + gk] : 0.f;
      }
      for (int e = tid; e < WR * WD; e += WT) {
        const int r = e / WD, c = e % WD, gk = k0 + c;
        float v = 0.f;
        if (r < nr && gk < d) {
          float s = 0.f;
          if constexpr (sizeof(T) == 1) s = scale[r0 + r];
          v = widen(corpus[(size_t)(r0 + r) * d + gk], s);
        }
        Rs[r * WLD + c] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < WD; kk += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * WLD +
                                                  kk);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(Rs + (tx + 16 * j) * WLD +
                                                  kk);
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
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = ty + 16 * i, r = tx + 16 * j;
      if (b < nq && r < nr)
        dist[(size_t)(b0 + b) * N + r0 + r] =
            (ok >> (4 * i + j)) & 1u ? acc[i][j] : CUDART_INF_F;
    }
}

// One block a query b of the chunk: the k smallest finite entries of
// dist[b * N .. + N) by (distance, row), written to out_i/out_d[b * k ..]
// with (-1, +inf) past the finite count. ka/ia and kb/ib hold k keys and
// ids a query: the compacted candidates and the sort's other buffer.
__global__ void __launch_bounds__(ST)
wide_select_kernel(const float* __restrict__ dist, int N, int k,
                   unsigned* __restrict__ ka, int* __restrict__ ia,
                   unsigned* __restrict__ kb, int* __restrict__ ib,
                   int* __restrict__ out_i, float* __restrict__ out_d) {
  __shared__ int hist[256];
  __shared__ int wc[SW * 256];         // per (warp, digit) counts, offsets
  __shared__ int ws[2 * SW];
  __shared__ int sh[3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const size_t b = blockIdx.x;
  const unsigned* key = reinterpret_cast<const unsigned*>(dist) + b * N;
  ka += b * k;
  ia += b * k;
  kb += b * k;
  ib += b * k;
  out_i += b * k;
  out_d += b * k;

  // ---- the k-th smallest finite key, 8 bits a pass from the top
  unsigned prefix = 0u, pmask = 0u;
  int want = k, finite = 0;
  bool all = false;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int e = tid; e < 256; e += ST) hist[e] = 0;
    __syncthreads();
    for (int s0 = 0; s0 < N; s0 += ST) {
      const int r = s0 + tid;
      const unsigned x = r < N ? __ldg(key + r) : INF_BITS;
      const bool in = x < INF_BITS && (x & pmask) == prefix;
      const unsigned act = __ballot_sync(0xffffffffu, in);
      if (in) {
        const int bin = (x >> shift) & 255;
        const unsigned peers = __match_any_sync(act, bin);
        if (lane == __ffs(peers) - 1) atomicAdd(hist + bin, __popc(peers));
      }
    }
    __syncthreads();
    if (tid == 0) {
      int tot = 0, v = 0, acc = 0;
      for (int e = 0; e < 256; ++e) tot += hist[e];
      for (v = 0; v < 255 && acc + hist[v] < want; ++v) acc += hist[v];
      sh[0] = v;
      sh[1] = acc;
      sh[2] = tot;
    }
    __syncthreads();
    if (pass == 0) {
      finite = sh[2];
      if (finite <= k) {               // every finite entry is kept
        all = true;
        break;
      }
    }
    prefix |= (unsigned)sh[0] << shift;
    pmask |= 0xffu << shift;
    want -= sh[1];
    __syncthreads();
  }

  // ---- compaction in row order: every key below the k-th, then the
  // first `take` rows whose key equals it
  const unsigned thr = all ? INF_BITS : prefix;
  const int take = all ? 0 : want;
  const int n_lt = all ? finite : k - want;
  const int cnt = n_lt + take;
  int run_lt = 0, run_eq = 0;
  for (int s0 = 0; s0 < N && (run_lt < n_lt || run_eq < take); s0 += ST) {
    const int r = s0 + tid;
    const unsigned x = r < N ? __ldg(key + r) : INF_BITS;
    const bool lt = x < thr, eq = !all && x == thr;
    const unsigned blt = __ballot_sync(0xffffffffu, lt);
    const unsigned beq = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) {
      ws[warp] = __popc(blt);
      ws[SW + warp] = __popc(beq);
    }
    __syncthreads();
    int off_lt = run_lt, off_eq = run_eq;
#pragma unroll
    for (int w = 0; w < SW; ++w) {
      if (w < warp) {
        off_lt += ws[w];
        off_eq += ws[SW + w];
      }
      run_lt += ws[w];
      run_eq += ws[SW + w];
    }
    if (lt) {
      const int p = off_lt + __popc(blt & below);
      ka[p] = x;
      ia[p] = r;
    }
    if (eq) {
      const int e = off_eq + __popc(beq & below);
      if (e < take) {
        ka[n_lt + e] = x;
        ia[n_lt + e] = r;
      }
    }
    __syncthreads();
  }

  // ---- stable LSD radix sort of the cnt candidates by key, 8 bits a
  // pass; the last pass writes the output
  unsigned* sk = ka;
  int* si = ia;
  unsigned* dk = kb;
  int* di = ib;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 8 * pass;
    for (int e = tid; e < 256; e += ST) hist[e] = 0;
    __syncthreads();
    for (int e = tid; e < cnt; e += ST)
      atomicAdd(hist + ((sk[e] >> shift) & 255), 1);
    __syncthreads();
    if (tid == 0) {                    // exclusive prefix: each digit's base
      int acc = 0;
      for (int v = 0; v < 256; ++v) {
        const int t = hist[v];
        hist[v] = acc;
        acc += t;
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < cnt; c0 += ST) {
      const int e = c0 + tid;
      const bool valid = e < cnt;
      const unsigned x = valid ? sk[e] : 0u;
      const int id = valid ? si[e] : -1;
      const int dg = valid ? (int)((x >> shift) & 255) : 256;
      const unsigned peers = __match_any_sync(0xffffffffu, dg);
      const int rank = __popc(peers & below);
      for (int i = tid; i < SW * 256; i += ST) wc[i] = 0;
      __syncthreads();
      if (valid && rank == 0) wc[warp * 256 + dg] = __popc(peers);
      __syncthreads();
      if (tid < 256) {                 // digit tid: offsets of each warp
        int s = hist[tid];
        for (int w = 0; w < SW; ++w) {
          const int t = wc[w * 256 + tid];
          wc[w * 256 + tid] = s;
          s += t;
        }
        hist[tid] = s;
      }
      __syncthreads();
      if (valid) {
        const int p = wc[warp * 256 + dg] + rank;
        if (pass == 3) {
          out_i[p] = id;
          out_d[p] = __uint_as_float(x);
        } else {
          dk[p] = x;
          di[p] = id;
        }
      }
      __syncthreads();
    }
    unsigned* tk = sk;
    sk = dk;
    dk = tk;
    int* ti = si;
    si = di;
    di = ti;
  }
  for (int j = cnt + tid; j < k; j += ST) {
    out_i[j] = -1;
    out_d[j] = CUDART_INF_F;
  }
}

template <typename T, int MODE>
int launch_wide(const void* corpus, const void* side, const void* attrs,
                const void* q, const void* qlo, const void* qhi, void* dist,
                void* keys, void* ids, void* out_i, void* out_d, int B, int N,
                int d, int m, int k, int chunk, void* stream) {
  if (B == 0) return 0;
  if (k < 1 || k > N || d < 1 || chunk < 1 || (MODE != MASK && m < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nwords = (N + 31) >> 5;
  unsigned* ka = (unsigned*)keys;
  unsigned* kb = ka + (size_t)chunk * k;
  int* ia = (int*)ids;
  int* ib = ia + (size_t)chunk * k;
  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int nb = min(chunk, B - b0);
    const void* sd = side;
    if (MODE == WIN) sd = (const unsigned*)side + (size_t)b0 * nwords;
    const size_t ab = MODE == MASK ? 0 : (size_t)b0 * m;
    dim3 grid((N + WR - 1) / WR, (nb + WQ - 1) / WQ);
    wide_score_kernel<T, MODE><<<grid, WT, 0, s>>>(
        (const T*)corpus, sd, (const float*)attrs,
        (const float*)q + (size_t)b0 * d,
        MODE == MASK ? nullptr : (const float*)qlo + ab,
        MODE == MASK ? nullptr : (const float*)qhi + ab, (float*)dist, nb, N,
        d, m);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    wide_select_kernel<<<nb, ST, 0, s>>>(
        (const float*)dist, N, k, ka, ia, kb, ib,
        (int*)out_i + (size_t)b0 * k, (float*)out_d + (size_t)b0 * k);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// One entry per form. `side` is the int8 form's (N) scale, the windowed
// form's (B, ceil(N / 32)) coverage bitmap (window_cover's in
// scan_topk.cu), the bitmask form's (N) f32 mask (> 0 passes), null for
// the f32 and bf16 box forms; the bitmask form ignores attrs, qlo, qhi
// and m. `chunk` queries are scored and selected at a time: dist holds
// chunk * N floats, keys and ids 2 * chunk * k words each.
#define WIDE_ENTRY(NAME, T, MODE)                                            \
  extern "C" int NAME(const void* corpus, const void* side,                  \
                      const void* attrs, const void* q, const void* qlo,     \
                      const void* qhi, void* dist, void* keys, void* ids,    \
                      void* out_i, void* out_d, int B, int N, int d, int m,  \
                      int k, int chunk, void* stream) {                      \
    return launch_wide<T, MODE>(corpus, side, attrs, q, qlo, qhi, dist,      \
                                keys, ids, out_i, out_d, B, N, d, m, k,      \
                                chunk, stream);                              \
  }

WIDE_ENTRY(scan_topk_wide_f32, float, BOX)
WIDE_ENTRY(scan_topk_wide_bf16, __nv_bfloat16, BOX)
WIDE_ENTRY(scan_topk_wide_q8, int8_t, BOX)
WIDE_ENTRY(scan_topk_windows_wide_f32, float, WIN)
WIDE_ENTRY(scan_topk_windows_wide_bf16, __nv_bfloat16, WIN)
WIDE_ENTRY(scan_topk_mask_wide_f32, float, MASK)
WIDE_ENTRY(scan_topk_mask_wide_bf16, __nv_bfloat16, MASK)
