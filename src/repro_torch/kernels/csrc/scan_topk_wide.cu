// The scan family's wide form, for Hopper (sm_90a): the exact
// predicate-masked top-k of scan_topk.cu for any 1 <= k <= N and any
// number of attributes m >= 1, where scan_topk.cu's kernels hold each
// query's running top-k in shared memory and so take k <= 64 and m <= 8.
// Its forms: the box scan over an f32, bf16 or int8 corpus, the bitmask
// scan over an f32 or bf16 corpus, and the windowed scan over an f32 or
// bf16 position-ordered corpus (the coverage bitmap comes from
// scan_topk.cu's window_cover).
//
// Replaces: src/repro/kernels/scan_topk.py:scan_topk_kernel (and its bf16
// use), src/repro/kernels/scan_topk.py:scan_topk_q8_kernel,
// src/repro/kernels/scan_topk.py:scan_topk_mask_kernel and
// src/repro/kernels/scan_topk.py:scan_topk_windows_kernel, for the k and m
// that scan_topk.cu's kernels do not take. The reference's kernels check
// only 1 <= k <= N; so does this one.
//
// Computes what scan_topk.cu computes: per query b, the k rows with the
// smallest sum_j (q[b,j] - row(r)[j])^2 among the rows that pass (the box
// all(qlo[b] <= a <= qhi[b]), NaN failing; or, bitmask, mask[r] > 0; and,
// windowed, inside one of the lane's windows), ascending by (distance,
// row id) -- ties to the lowest id, as lax.top_k -- and (-1, +inf) past
// the passing count. Each distance is scan_topk.cu's one fmaf chain
// acc = fmaf(q_j - row_j, q_j - row_j, acc) over ascending j (zero-padded
// past d, which adds exact zeros), so a wide form's distances are the
// narrow form's bit for bit on the same rows.
//
// Design: every form takes a threshold and candidate lists. This file
// includes scan_topk.cu for its kernels, so the forms score with the
// narrow forms' own loops, only the sink changed (ListSink):
//   1. sample: the narrow scoring over 1 in 16 row tiles (the bitmask
//      form: 1 in 16 tiles of its compacted row list), every computed
//      pair into its query's list (cap entries a query; past it the count
//      runs on, the entries are dropped);
//   2. tau (list_tau_kernel, a block a query): tau[b] = the k-th smallest
//      distance among the sample's listed pairs, or +inf where fewer than
//      k were listed. Any k listed passing rows bound the final k-th
//      distance from above, so tau does;
//   3. score: the narrow scoring over every tile, each pair with distance
//      <= tau[b] (finite) appended to b's list as the key (distance bits
//      << 32 | row id), one atomic reservation a (query, tile or round);
//   4. overflow (list_overflow_kernel, a block a query whose count passed
//      cap): an exact radix select of the k-th (distance, id) key over its
//      passing rows, recomputed a pass at a time in row order (no list
//      needed), then its k keys written to the list; a device counter
//      counts these queries. The plain version is never the way out;
//   5. select (list_select_kernel, a block a query): a radix select of the
//      k-th key over the listed keys (the id in the key, so ties need no
//      list order), a compaction, and a stable LSD radix sort of the k
//      keys. No library sort, top-k or GEMM is used.
//   The box form's scoring is box_scan_body's (per 256-row tile, the
//   attrs tested against every box 8 at a time, so any m; empty tiles
//   skipped, sparse tiles pair by pair in slot rounds, dense tiles in
//   32-row sub-tiles with a 4 x 4 register tile; bf16 widened and int8
//   scaled with __fmul_rn as the rows are staged). The windowed form's is
//   the same body's windowed instance (box_scan_list_kernel<T, VEC,
//   true>): window_cover's pre-pass marks each lane's rows in a (chunk,
//   ceil(N / 32)) bitmap and each (256-query block, row tile) some lane
//   covers, at the plan's tile height, so both passes skip a tile no lane
//   of the block covers before staging its attrs, and AND each box-test
//   word with the lane's coverage word: only covered, passing pairs are
//   scored, sparse tiles pair by pair, dense ones in sub-tiles. Its keys
//   hold positions, unique, so the (distance, position) order is the
//   reference's tie order; its exact re-pass tests the coverage bit
//   before the box. The bitmask form's is mask_partial_body's over the
//   compaction of mask_count_kernel and mask_compact_kernel (128 queries
//   x 64 gathered rows a block, 8 x 4 pairs a thread, cp.async
//   double-buffered 32-wide slabs).
// What this does about the costs of the plane design these forms had
// (scripts/wide_split.py on an H100 80GB HBM3 at 700 W: 24-30 ms at B =
// 256, N = 1M, d = 768; every 64 x 64 tile live for the box and bitmask
// forms, 47,516 for the windowed; in a live block 47-62% of thread 0's
// cycles on the scalar, single-buffered slab loads, 32-44% in the FMA
// loop; a (chunk, N) f32 plane written once and read five times by the
// select): only covered, passing pairs are scored, on the narrow forms'
// double-buffered slabs and larger register tiles; no plane, only ~16k
// (k times the sample's inverse) candidates a query pass the threshold,
// so the select reads a few thousand keys a query, not N five times.
// Bound on the H100, as scan_topk.cu's: the box form reads the corpus and
// attrs once (~3.1 GB f32, ~1.55 GB bf16, ~0.79 GB int8 at N = 1M, d =
// 768) against 3 flops per (passing pair, dimension); the windowed form
// the attrs of every covered row and the vector of every row that passes
// a covering lane's box, each once, against 3 flops per dimension of each
// passing (lane, row) pair; the bitmask form's 3 flops per (query,
// passing row, dimension) bound it (4.75 ms at B = 256 and 539,333 rows
// at 67 TFLOP/s; two fp32 instructions a pair and dimension make a 6.3 ms
// ceiling). The sample adds ~1/16 of the scoring; the lists, tau and the
// select move a few MB.

#define SCAN_TOPK_DEVICE_ONLY
#include "scan_topk.cu"

namespace {

constexpr int ST = 512;              // threads of a select block
constexpr int SW = ST / 32;          // its warps

using u64 = unsigned long long;

__device__ __forceinline__ float widen(float v, float) { return v; }

// ---- the candidate lists (the box, windowed and bitmask forms)

// The k-th smallest of the 64-bit keys that each(f) hands to f(key,
// valid) -- every thread of the block calls each, which loops the same
// number of times in every thread -- by a radix select over 8-bit digits
// from the top, npass passes at most (a histogram a pass in `hist`,
// warp-aggregated atomics). Returns prefix and pmask: the keys with (key
// & pmask) <= prefix are the k smallest, or all of them when the valid
// keys number total <= k (pmask = prefix = 0). With `exact` the passes
// run on while a bin holds more keys than it needs and only total < k
// takes all, so prefix holds the k-th key's top 8 * npass bits; without
// it the select stops at the first digit whose bin is wanted whole.
template <typename Each>
__device__ void block_kth(Each&& each, int k, int npass, bool exact,
                          int* hist, int* sh, u64& prefix, u64& pmask,
                          int& total) {
  const int tid = threadIdx.x, lane = tid & 31;
  prefix = 0ull;
  pmask = 0ull;
  total = 0;
  int want = k;
  for (int pass = 0; pass < npass; ++pass) {
    const int shift = 56 - 8 * pass;
    for (int e = tid; e < 256; e += blockDim.x) hist[e] = 0;
    __syncthreads();
    each([&](u64 key, bool valid) {
      const bool in = valid && (key & pmask) == prefix;
      const unsigned act = __ballot_sync(0xffffffffu, in);
      if (in) {
        const int bin = (int)(key >> shift) & 255;
        const unsigned peers = __match_any_sync(act, bin);
        if (lane == __ffs(peers) - 1) atomicAdd(hist + bin, __popc(peers));
      }
    });
    __syncthreads();
    if (tid == 0) {
      int tot = 0, acc = 0, v = 0;
      for (int e = 0; e < 256; ++e) tot += hist[e];
      for (v = 0; v < 255 && acc + hist[v] < want; ++v) acc += hist[v];
      sh[0] = v;
      sh[1] = acc;
      sh[2] = tot;
      sh[3] = hist[v];
    }
    __syncthreads();
    const int v = sh[0], acc = sh[1], tot = sh[2], inbin = sh[3];
    __syncthreads();                   // sh is written again below
    if (pass == 0) {
      total = tot;
      if (tot < k || (!exact && tot == k)) return;
    }
    prefix |= (u64)v << shift;
    pmask |= 0xffull << shift;
    want -= acc;
    if (!exact && inbin == want) return;
  }
}

// Writes the keys each(f) hands over with (key & pmask) <= prefix to
// dst[0 ..) in no order (a warp ballot, one reservation a warp in sh[0])
// and returns their count.
template <typename Each>
__device__ int block_take(Each&& each, u64 prefix, u64 pmask, u64* dst,
                          int* sh) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  if (threadIdx.x == 0) sh[0] = 0;
  __syncthreads();
  each([&](u64 key, bool valid) {
    const bool sel = valid && (key & pmask) <= prefix;
    const unsigned bal = __ballot_sync(0xffffffffu, sel);
    int base = 0;
    if (lane == 0 && bal) base = atomicAdd(sh, __popc(bal));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (sel) dst[base + __popc(bal & below)] = key;
  });
  __syncthreads();
  const int n = sh[0];
  __syncthreads();
  return n;
}

// The listed keys of query blockIdx.x: list[b * cap + e] for e < n.
struct Listed {
  const u64* src;
  int n;
  template <typename F>
  __device__ void operator()(F&& f) const {
    for (int s0 = 0; s0 < n; s0 += ST) {
      const int e = s0 + threadIdx.x;
      f(e < n ? src[e] : 0ull, e < n);
    }
  }
};

// tau[b] for query b = blockIdx.x: the k-th smallest distance of its
// sample list (its first min(count[b], cap) entries), +inf where it holds
// fewer than k; then count[b] = 0 for the score pass.
__global__ void __launch_bounds__(ST)
list_tau_kernel(const u64* __restrict__ list, int* __restrict__ count,
                int cap, int k, float* __restrict__ tau) {
  __shared__ int hist[256];
  __shared__ int sh[4];
  const size_t b = blockIdx.x;
  const Listed each{list + b * cap, min(count[b], cap)};
  u64 prefix, pmask;
  int total;
  block_kth(each, k, 4, true, hist, sh, prefix, pmask, total);
  if (threadIdx.x == 0) {
    tau[b] = total < k ? CUDART_INF_F
                       : __uint_as_float((unsigned)(prefix >> 32));
    count[b] = 0;
  }
}

// A query whose score pass listed more than cap pairs (count[b] > cap),
// b = blockIdx.x: its k smallest (distance, id) keys among the passing
// rows within tau[b], by a radix select whose every pass recomputes the
// rows' distances (a thread a row, rows in order: the box test, the
// windowed form's coverage bit before it, or the bitmask's compacted
// rows; the one fmaf chain), written to its list with count[b] = k. Every
// query's count goes to raw[b] first; *overflows counts the queries that
// took this path. `cov` is null but for the windowed form: its (B,
// ceil(N / 32)) coverage bitmap.
template <typename T, bool MASKF>
__global__ void __launch_bounds__(ST)
list_overflow_kernel(const T* __restrict__ corpus,
                     const float* __restrict__ scale,
                     const float* __restrict__ attrs,
                     const float* __restrict__ q,
                     const float* __restrict__ qlo,
                     const float* __restrict__ qhi,
                     const int* __restrict__ rows,
                     const unsigned* __restrict__ cov,
                     const float* __restrict__ tau,
                     u64* __restrict__ list, int* __restrict__ count,
                     int* __restrict__ raw, int* __restrict__ overflows,
                     int N, int d, int m, int cap, int k) {
  __shared__ int hist[256];
  __shared__ int sh[4];
  const size_t b = blockIdx.x;
  const int nb = count[b];             // thread 0 rewrites it past syncs
  if (threadIdx.x == 0) raw[b] = nb;
  if (nb <= cap) return;
  if (threadIdx.x == 0) atomicAdd(overflows, 1);
  const float tb = tau[b];
  const float* qb = q + b * d;
  // the bitmask form's row list and its length (scan_topk.cu's layout)
  const int n = MASKF ? rows[N + (N + SEG - 1) / SEG] : N;
  auto each = [&](auto&& f) {
    for (int s0 = 0; s0 < n; s0 += ST) {
      const int v = s0 + threadIdx.x;
      bool ok = v < n;
      const int r = !ok ? 0 : MASKF ? __ldg(rows + v) : v;
      if (!MASKF && ok && cov != nullptr)
        ok = (__ldg(cov + b * ((N + 31) >> 5) + (r >> 5)) >> (r & 31)) & 1u;
      for (int a = 0; !MASKF && ok && a < m; ++a) {
        const float x = attrs[(size_t)r * m + a];
        ok = (x >= qlo[b * m + a]) & (x <= qhi[b * m + a]);
      }
      float acc = 0.f;
      if (ok) {
        const T* row = corpus + (size_t)r * d;
        const float s = sizeof(T) == 1 ? scale[r] : 0.f;
        for (int j = 0; j < d; ++j) {
          const float t = __ldg(qb + j) - widen(row[j], s);
          acc = fmaf(t, t, acc);
        }
        ok = acc <= tb && acc < CUDART_INF_F;
      }
      f(list_key(acc, r), ok);
    }
  };
  u64 prefix, pmask;
  int total;
  block_kth(each, k, 8, false, hist, sh, prefix, pmask, total);
  const int got = block_take(each, prefix, pmask, list + b * cap, sh);
  if (threadIdx.x == 0) count[b] = got;
}

// Stable LSD radix sort of cnt 64-bit keys in sk (dk the other buffer),
// 8 bits a pass; a pass whose digit is the same in every key moves
// nothing. Returns the buffer that holds the sorted keys.
__device__ u64* block_sort(u64* sk, u64* dk, int cnt, int* hist, int* wc,
                           int* sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int pass = 0; pass < 8; ++pass) {
    const int shift = 8 * pass;
    for (int e = tid; e < 256; e += ST) hist[e] = 0;
    __syncthreads();
    for (int e = tid; e < cnt; e += ST)
      atomicAdd(hist + (int)((sk[e] >> shift) & 255), 1);
    __syncthreads();
    if (tid == 0) {                    // exclusive prefix: each digit's base
      int acc = 0, one = 0;
      for (int v = 0; v < 256; ++v) {
        const int t = hist[v];
        one |= t == cnt;
        hist[v] = acc;
        acc += t;
      }
      sh[0] = one;
    }
    __syncthreads();
    if (sh[0]) continue;               // sh[0] is next written past 2 syncs
    for (int c0 = 0; c0 < cnt; c0 += ST) {
      const int e = c0 + tid;
      const bool valid = e < cnt;
      const u64 x = valid ? sk[e] : 0ull;
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
      if (valid) dk[wc[warp * 256 + dg] + rank] = x;
      __syncthreads();
    }
    u64* t = sk;
    sk = dk;
    dk = t;
  }
  return sk;
}

// Query b = blockIdx.x: the k smallest listed keys (its first min(count[b],
// cap) entries), ascending, to out_i/out_d[b * k ..] as (id, distance),
// (-1, +inf) past their count. ka/kb hold k keys a query.
__global__ void __launch_bounds__(ST)
list_select_kernel(const u64* __restrict__ list,
                   const int* __restrict__ count, int cap, int k,
                   u64* __restrict__ ka, u64* __restrict__ kb,
                   int* __restrict__ out_i, float* __restrict__ out_d) {
  __shared__ int hist[256];
  __shared__ int wc[SW * 256];         // per (warp, digit) counts, offsets
  __shared__ int sh[4];
  const size_t b = blockIdx.x;
  const Listed each{list + b * cap, min(count[b], cap)};
  ka += b * k;
  kb += b * k;
  out_i += b * k;
  out_d += b * k;
  u64 prefix, pmask;
  int total;
  block_kth(each, k, 8, false, hist, sh, prefix, pmask, total);
  const int cnt = block_take(each, prefix, pmask, ka, sh);
  const u64* res = block_sort(ka, kb, cnt, hist, wc, sh);
  for (int j = threadIdx.x; j < k; j += ST) {
    const bool in = j < cnt;
    out_i[j] = in ? (int)(unsigned)res[j] : -1;
    out_d[j] = in ? __uint_as_float((unsigned)(res[j] >> 32)) : CUDART_INF_F;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// One scoring pass of the box form into the lists over 1 in tstride row
// tiles (the sample, with tau null; the score pass: 1 and tau): tr-row
// tiles, `blocks` blocks a 256-query block, smem =
// box_scan_smem_words(tr, 0) * 4 (ops._scan_plan at k = 0); sched holds
// ceil(B / 256) + 3 ints. With `cov` (window_cover's at the same B, N
// and tr) the windowed instance, whose sched holds one more int (the
// uncovered tiles).
template <typename T>
int launch_box_list(const void* corpus, const void* scale, const void* cov,
                    const void* attrs, const void* q, const void* qlo,
                    const void* qhi, const void* tau, void* list,
                    void* count, void* sched, int B, int N, int d, int m,
                    int cap, int tstride, int tr, int blocks, int smem,
                    void* stream) {
  if (B == 0) return 0;
  if (N < 1 || d < 1 || m < 1 || cap < 1 || tstride < 1 || blocks < 1 ||
      (tr != 64 && tr != 128 && tr != 256) ||
      smem != box_scan_smem_words(tr, 0) * (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  const int qblocks = (B + BQ - 1) / BQ;
  if (qblocks > 65535) return (int)cudaErrorInvalidConfiguration;
  const bool win = cov != nullptr;
  if (win && sizeof(T) == 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      cudaMemsetAsync(sched, 0, (qblocks + 3 + win) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const bool vec = d % Vec<T>::V == 0 && aligned16(corpus) && aligned16(q);
  // no int8 windowed form: its instance is not built
  constexpr bool W8 = sizeof(T) != 1;
  auto kern = win ? (vec ? box_scan_list_kernel<T, true, W8>
                         : box_scan_list_kernel<T, false, W8>)
                  : (vec ? box_scan_list_kernel<T, true, false>
                         : box_scan_list_kernel<T, false, false>);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  const ListSink ls{(const float*)tau, (u64*)list, (int*)count, cap,
                    tstride};
  kern<<<dim3(blocks, qblocks), BT, smem, s>>>(
      (const T*)corpus, (const float*)scale, (const float*)attrs,
      (const float*)q, (const float*)qlo, (const float*)qhi,
      (const unsigned*)cov, (int*)sched, B, N, d, m, tr, ls);
  return (int)cudaGetLastError();
}

// One scoring pass of the bitmask form over the compaction in `rows`
// (wide_mask_compact's), as launch_box_list's.
template <typename T>
int launch_mask_list(const void* corpus, const void* rows, const void* q,
                     const void* tau, void* list, void* count, int B, int N,
                     int d, int cap, int tstride, int nchunks, void* stream) {
  if (B == 0) return 0;
  if (N < 1 || d < 1 || cap < 1 || tstride < 1 || nchunks < 1)
    return (int)cudaErrorInvalidValue;
  if (nchunks > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = d % Vec<T>::V == 0 && aligned16(corpus) && aligned16(q);
  auto kern = vec ? mask_list_kernel<T, true> : mask_list_kernel<T, false>;
  const int smem = (2 * MSTAGE + MQ * (MR + 1)) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int* list_rows = (const int*)rows;
  const ListSink ls{(const float*)tau, (u64*)list, (int*)count, cap,
                    tstride};
  kern<<<dim3((B + MQ - 1) / MQ, nchunks), 256, smem, s>>>(
      (const T*)corpus, list_rows, list_rows + N + (N + SEG - 1) / SEG,
      (const float*)q, B, d, ls);
  return (int)cudaGetLastError();
}

template <typename T, bool MASKF>
int launch_overflow(const void* corpus, const void* scale, const void* attrs,
                    const void* q, const void* qlo, const void* qhi,
                    const void* rows, const void* cov, const void* tau,
                    void* list,
                    void* count, void* raw, void* overflows, int B, int N,
                    int d, int m, int cap, int k, void* stream) {
  if (B == 0) return 0;
  if (k < 1 || k > cap || d < 1 || (!MASKF && m < 1))
    return (int)cudaErrorInvalidValue;
  list_overflow_kernel<T, MASKF><<<B, ST, 0, (cudaStream_t)stream>>>(
      (const T*)corpus, (const float*)scale, (const float*)attrs,
      (const float*)q, (const float*)qlo, (const float*)qhi,
      (const int*)rows, (const unsigned*)cov, (const float*)tau,
      (u64*)list, (int*)count,
      (int*)raw, (int*)overflows, N, d, m, cap, k);
  return (int)cudaGetLastError();
}

}  // namespace

// The box, windowed and bitmask forms, a phase an entry, for a chunk of B
// queries whose candidate lists hold cap keys each (list: B * cap u64,
// count: B ints, zeroed before the sample pass; tau: B floats).
//
// wide_box_list_*: a scoring pass of the box form over 1 in tstride row
// tiles; `side` the int8 form's (N) scale; `cov` null, or the windowed
// form's coverage (window_cover's for the chunk at the same tr: f32 and
// bf16 only); tau null (+inf) for the sample.
#define BOX_LIST_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* corpus, const void* side, const void* cov, \
                      const void* attrs, const void* q, const void* qlo,     \
                      const void* qhi, const void* tau, void* list,          \
                      void* count, void* sched, int B, int N, int d, int m,  \
                      int cap, int tstride, int tr, int blocks, int smem,    \
                      void* stream) {                                        \
    return launch_box_list<T>(corpus, side, cov, attrs, q, qlo, qhi, tau,    \
                              list, count, sched, B, N, d, m, cap, tstride,  \
                              tr, blocks, smem, stream);                     \
  }

BOX_LIST_ENTRY(wide_box_list_f32, float)
BOX_LIST_ENTRY(wide_box_list_bf16, __nv_bfloat16)
BOX_LIST_ENTRY(wide_box_list_q8, int8_t)

// wide_mask_compact: the bitmask's passing rows, ascending, into `rows`
// (N + ceil(N / 8192) + 1 ints: the rows, the per-segment counts, the
// count), by scan_topk.cu's mask_count_kernel and mask_compact_kernel.
extern "C" int wide_mask_compact(const void* mask, int N, void* rows,
                                 void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = (N + SEG - 1) / SEG;
  int* list_rows = (int*)rows;
  mask_count_kernel<<<nblk, 256, 0, s>>>((const float*)mask, N,
                                         list_rows + N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mask_compact_kernel<<<nblk, 256, 0, s>>>((const float*)mask, N,
                                           list_rows + N, nblk, list_rows,
                                           list_rows + N + nblk);
  return (int)cudaGetLastError();
}

// wide_mask_list_*: a scoring pass of the bitmask form over 1 in tstride
// 64-row tiles of `rows`, in nchunks chunks (ops._mask_chunking).
#define MASK_LIST_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* corpus, const void* rows, const void* q,  \
                      const void* tau, void* list, void* count, int B,       \
                      int N, int d, int cap, int tstride, int nchunks,       \
                      void* stream) {                                        \
    return launch_mask_list<T>(corpus, rows, q, tau, list, count, B, N, d,   \
                               cap, tstride, nchunks, stream);               \
  }

MASK_LIST_ENTRY(wide_mask_list_f32, float)
MASK_LIST_ENTRY(wide_mask_list_bf16, __nv_bfloat16)

// wide_list_tau: tau from the sample lists, then the counts zeroed.
extern "C" int wide_list_tau(const void* list, void* count, int B, int cap,
                             int k, void* tau, void* stream) {
  if (B == 0) return 0;
  if (k < 1 || cap < 1) return (int)cudaErrorInvalidValue;
  list_tau_kernel<<<B, ST, 0, (cudaStream_t)stream>>>(
      (const u64*)list, (int*)count, cap, k, (float*)tau);
  return (int)cudaGetLastError();
}

// wide_*_overflow_*: the queries whose lists overflowed, finished exactly;
// raw (B ints) takes every query's listed count, *overflows counts the
// queries finished here. The bitmask entries read `rows`, the box entries
// `side` (the int8 scale), `cov` (the windowed form's, or null), attrs
// and the boxes.
#define BOX_OVERFLOW_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* corpus, const void* side, const void* cov, \
                      const void* attrs, const void* q, const void* qlo,     \
                      const void* qhi, const void* tau, void* list,          \
                      void* count, void* raw, void* overflows, int B, int N, \
                      int d, int m, int cap, int k, void* stream) {          \
    return launch_overflow<T, false>(corpus, side, attrs, q, qlo, qhi,       \
                                     nullptr, cov, tau, list, count, raw,    \
                                     overflows, B, N, d, m, cap, k, stream); \
  }
#define MASK_OVERFLOW_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* corpus, const void* rows, const void* q,  \
                      const void* tau, void* list, void* count, void* raw,   \
                      void* overflows, int B, int N, int d, int cap, int k,  \
                      void* stream) {                                        \
    return launch_overflow<T, true>(corpus, nullptr, nullptr, q, nullptr,    \
                                    nullptr, rows, nullptr, tau, list,       \
                                    count, raw, overflows, B, N, d, 0, cap,  \
                                    k, stream);                              \
  }

BOX_OVERFLOW_ENTRY(wide_box_overflow_f32, float)
BOX_OVERFLOW_ENTRY(wide_box_overflow_bf16, __nv_bfloat16)
BOX_OVERFLOW_ENTRY(wide_box_overflow_q8, int8_t)
MASK_OVERFLOW_ENTRY(wide_mask_overflow_f32, float)
MASK_OVERFLOW_ENTRY(wide_mask_overflow_bf16, __nv_bfloat16)

// wide_list_select: each query's k smallest listed keys, sorted, to
// out_i/out_d (B, k); keys holds 2 * B * k u64.
extern "C" int wide_list_select(const void* list, const void* count, int B,
                                int cap, int k, void* keys, void* out_i,
                                void* out_d, void* stream) {
  if (B == 0) return 0;
  if (k < 1 || cap < 1) return (int)cudaErrorInvalidValue;
  u64* ka = (u64*)keys;
  list_select_kernel<<<B, ST, 0, (cudaStream_t)stream>>>(
      (const u64*)list, (const int*)count, cap, k, ka, ka + (size_t)B * k,
      (int*)out_i, (float*)out_d);
  return (int)cudaGetLastError();
}
