// Fused gather + squared L2 over candidate ids, for Hopper (sm_90a), over an
// f32 corpus, its bf16 replica or its int8 replica: the predicate-fused form
// and the two unfused forms.
//
// Replaces: src/repro/kernels/gather_l2_filter.py:gather_l2_filter_blocked_kernel
// (the Pallas TPU kernel behind backend="pallas_gather_l2_filter", which the
// reference also runs on the bf16 replica),
// src/repro/kernels/gather_l2_filter.py:gather_l2_filter_q8_blocked_kernel
// (its int8-replica form, quant="int8"),
// src/repro/kernels/gather_l2.py:gather_l2_blocked_kernel (the unfused
// blocked gather behind backend="pallas_gather_l2") and
// src/repro/kernels/gather_l2.py:gather_l2_kernel (its row-per-step
// validation form, the default of the public ops.gather_l2).
//
// Computes, per lane (b, c) with id = idx[b, c]:
//   out[b, c] = sum_j (q[b, j] - row(id)[j])^2   if 0 <= id < N and
//               all_a(qlo[b, a] <= attrs[id, a] <= qhi[b, a]),
//               +inf otherwise (pad lanes, out-of-range ids, failed
//               predicate; NaN attrs fail every comparison),
// where row(id) is corpus[id] (f32), float(corpus[id]) (bf16), or
// float(qcorpus[id]) * qscale[id] (int8, the product rounded on its own as
// the reference's dequant_rows writes it, then q - row). Sums are f32. The
// unfused forms drop the predicate (a compile-time flag of the same kernel,
// or the row-per-step kernel) and keep the +inf for ids outside [0, N): the
// reference's caller clamps them, and no id may read past the corpus.
//
// Bound on the H100: bytes. Every surviving lane reads one row (4d bytes
// f32, 2d bf16, d + 4 int8 with its scale) and, when filtered, its m attrs
// once, and nothing is reused across lanes, so at the main path's B=256,
// C=128, d=768 with ~90% of lanes passing a call moves ~92 MB in f32
// (~27 us at 3.35 TB/s), ~47 MB in bf16 and ~24 MB in int8; the unfused
// gather reads every lane's row, ~101 MB in f32 (~30 us). The arithmetic
// (3 flops per element, plus a multiply for int8) is far below the card's
// fp32 rate.
//
// Design: one warp per candidate lane, the query row staged in shared
// memory. The filtered form tests the m attrs first (one lane per attr,
// __all_sync), so a lane that fails the predicate never reads its vector
// row. A row streams as coalesced 16-byte loads (4 f32, 8 bf16 or 16 int8
// values; d=768 is 192, 96 or 48 loads), is widened to f32 in registers and
// reduces with a warp shuffle tree. Every form computes a row's distance
// with the one device function row_l2 and the same 16-byte-load rule, so
// on the same corpus, query and id the three forms' finite lanes are
// bitwise equal (the reference pins the same for its kernels). One
// template over the element type serves the three corpora. The blocked
// kernel gives a block of 8 warps to 8 lanes of one query, staging the
// query once per block; the row-per-step kernel follows the TPU grid
// (B, C), one single-warp block per lane. The kernels allocate nothing;
// the wrapper sizes `out`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

enum class Kind { F32, BF16, I8 };

template <Kind K> struct Elem;
template <> struct Elem<Kind::F32> { using T = float; static constexpr int V = 4; };
template <> struct Elem<Kind::BF16> { using T = __nv_bfloat16; static constexpr int V = 8; };
template <> struct Elem<Kind::I8> { using T = int8_t; static constexpr int V = 16; };

template <Kind K>
__device__ __forceinline__ float widen(typename Elem<K>::T v, float s) {
  if constexpr (K == Kind::F32) {
    return v;
  } else if constexpr (K == Kind::BF16) {
    return __bfloat162float(v);
  } else {
    return __fmul_rn(static_cast<float>(v), s);   // never fused into q - r
  }
}

// The squared L2 distance of one row to the staged query, by the whole
// warp: lane-strided f32 fmaf over 16-byte loads when `vec` (every row
// start on a 16-byte boundary and d a multiple of the load's width), else
// over scalar loads, then an xor-shuffle tree. Every lane returns the sum.
template <Kind K>
__device__ __forceinline__ float row_l2(const typename Elem<K>::T* row,
                                        const float4* qs4, int d, int lane,
                                        bool vec, float s) {
  using T = typename Elem<K>::T;
  constexpr int V = Elem<K>::V;
  const float* qs = reinterpret_cast<const float*>(qs4);
  float acc = 0.f;
  if (vec) {
    const uint4* r16 = reinterpret_cast<const uint4*>(row);
    for (int j = lane; j < d / V; j += 32) {
      const uint4 raw = __ldg(r16 + j);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < V / 4; ++u) {
        const float4 v = qs4[j * (V / 4) + u];
        float t = v.x - widen<K>(e[4 * u + 0], s); acc = fmaf(t, t, acc);
        t = v.y - widen<K>(e[4 * u + 1], s); acc = fmaf(t, t, acc);
        t = v.z - widen<K>(e[4 * u + 2], s); acc = fmaf(t, t, acc);
        t = v.w - widen<K>(e[4 * u + 3], s); acc = fmaf(t, t, acc);
      }
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      const float t = qs[j] - widen<K>(row[j], s);
      acc = fmaf(t, t, acc);
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// Blocked form: grid (ceil(C / 8), B), 8 warps a block, one lane a warp.
// Filter = false compiles the predicate out (attrs, qlo and qhi unused).
template <typename IdxT, Kind K, bool Filter>
__global__ void gather_l2_filter_kernel(const IdxT* __restrict__ idx,
                                        const typename Elem<K>::T* __restrict__ corpus,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ attrs,
                                        const float* __restrict__ q,
                                        const float* __restrict__ qlo,
                                        const float* __restrict__ qhi,
                                        float* __restrict__ out,
                                        int C, int N, int d, int m, bool vec) {
  extern __shared__ float4 qs4[];
  float* qs = reinterpret_cast<float*>(qs4);
  const int b = blockIdx.y;
  const float* qrow = q + (size_t)b * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) qs[j] = qrow[j];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int c = blockIdx.x * kWarps + warp; c < C; c += gridDim.x * kWarps) {
    const long long id = (long long)idx[(size_t)b * C + c];
    float res = CUDART_INF_F;
    if (id >= 0 && id < N) {          // uniform across the warp
      bool pass = true;
      if constexpr (Filter) {
        const float* lo = qlo + (size_t)b * m;
        const float* hi = qhi + (size_t)b * m;
        bool ok = true;
        for (int a = lane; a < m; a += 32) {
          const float v = attrs[id * m + a];
          ok = ok && (v >= lo[a]) && (v <= hi[a]);
        }
        pass = __all_sync(0xffffffffu, ok);
      }
      if (pass) {
        const float s = K == Kind::I8 ? __ldg(scale + id) : 1.f;
        res = row_l2<K>(corpus + id * (long long)d, qs4, d, lane, vec, s);
      }
    }
    if (lane == 0) out[(size_t)b * C + c] = res;
  }
}

// Row-per-step form: grid (C, B), one single-warp block per lane (b, c),
// as the TPU kernel's grid steps one candidate row at a time.
template <typename IdxT, Kind K>
__global__ void gather_l2_rows_kernel(const IdxT* __restrict__ idx,
                                      const typename Elem<K>::T* __restrict__ corpus,
                                      const float* __restrict__ q,
                                      float* __restrict__ out,
                                      int C, int N, int d, bool vec) {
  extern __shared__ float4 qs4[];
  float* qs = reinterpret_cast<float*>(qs4);
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x;
  const float* qrow = q + (size_t)b * d;
  for (int j = lane; j < d; j += 32) qs[j] = qrow[j];
  __syncwarp();
  const long long id = (long long)idx[(size_t)b * C + c];
  float res = CUDART_INF_F;
  if (id >= 0 && id < N)
    res = row_l2<K>(corpus + id * (long long)d, qs4, d, lane, vec, 1.f);
  if (lane == 0) out[(size_t)b * C + c] = res;
}

// 16-byte row loads need every row start on a 16-byte boundary: the same
// rule for every form, so their sums take one instruction sequence
template <Kind K>
bool use_vec(const void* corpus, int d) {
  return d % Elem<K>::V == 0 && ((uintptr_t)corpus & 15) == 0;
}

template <typename KernelT>
int allow_smem(KernelT kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename IdxT, Kind K, bool Filter>
int launch(const void* idx, const void* corpus, const void* scale,
           const void* attrs, const void* q, const void* qlo, const void* qhi,
           void* out, int B, int C, int N, int d, int m, void* stream) {
  if (B == 0 || C == 0) return 0;
  const size_t smem = (size_t)d * sizeof(float);
  int e = allow_smem(gather_l2_filter_kernel<IdxT, K, Filter>, smem);
  if (e != 0) return e;
  int gx = (C + kWarps - 1) / kWarps;
  if (gx > 65535) gx = 65535;
  dim3 grid(gx, B);
  gather_l2_filter_kernel<IdxT, K, Filter><<<grid, kWarps * 32, smem,
                                             (cudaStream_t)stream>>>(
      (const IdxT*)idx, (const typename Elem<K>::T*)corpus,
      (const float*)scale, (const float*)attrs, (const float*)q,
      (const float*)qlo, (const float*)qhi, (float*)out, C, N, d, m,
      use_vec<K>(corpus, d));
  return (int)cudaGetLastError();
}

template <typename IdxT, Kind K>
int launch_rows(const void* idx, const void* corpus, const void* q,
                void* out, int B, int C, int N, int d, void* stream) {
  if (B == 0 || C == 0) return 0;
  const size_t smem = (size_t)d * sizeof(float);
  int e = allow_smem(gather_l2_rows_kernel<IdxT, K>, smem);
  if (e != 0) return e;
  dim3 grid(C, B);
  gather_l2_rows_kernel<IdxT, K><<<grid, 32, smem, (cudaStream_t)stream>>>(
      (const IdxT*)idx, (const typename Elem<K>::T*)corpus, (const float*)q,
      (float*)out, C, N, d, use_vec<K>(corpus, d));
  return (int)cudaGetLastError();
}

}  // namespace

// One entry per (corpus kind, id type). `scale` is read only by the int8
// (q8) entries; the others take a null pointer.
#define GATHER_ENTRY(NAME, IDXT, KIND)                                       \
  extern "C" int NAME(const void* idx, const void* corpus,                   \
                      const void* scale, const void* attrs, const void* q,   \
                      const void* qlo, const void* qhi, void* out, int B,    \
                      int C, int N, int d, int m, void* stream) {            \
    return launch<IDXT, KIND, true>(idx, corpus, scale, attrs, q, qlo, qhi,  \
                                    out, B, C, N, d, m, stream);             \
  }

GATHER_ENTRY(gather_l2_filter_f32_i32, int32_t, Kind::F32)
GATHER_ENTRY(gather_l2_filter_f32_i64, int64_t, Kind::F32)
GATHER_ENTRY(gather_l2_filter_bf16_i32, int32_t, Kind::BF16)
GATHER_ENTRY(gather_l2_filter_bf16_i64, int64_t, Kind::BF16)
GATHER_ENTRY(gather_l2_filter_q8_i32, int32_t, Kind::I8)
GATHER_ENTRY(gather_l2_filter_q8_i64, int64_t, Kind::I8)

// The unfused gathers: the blocked form (the filtered kernel with its
// predicate compiled out) and the row-per-step form.
#define UNFUSED_ENTRY(NAME, ROWS_NAME, IDXT, KIND)                           \
  extern "C" int NAME(const void* idx, const void* corpus, const void* q,    \
                      void* out, int B, int C, int N, int d, void* stream) { \
    return launch<IDXT, KIND, false>(idx, corpus, nullptr, nullptr, q,       \
                                     nullptr, nullptr, out, B, C, N, d, 0,   \
                                     stream);                                \
  }                                                                          \
  extern "C" int ROWS_NAME(const void* idx, const void* corpus,              \
                           const void* q, void* out, int B, int C, int N,    \
                           int d, void* stream) {                            \
    return launch_rows<IDXT, KIND>(idx, corpus, q, out, B, C, N, d, stream); \
  }

UNFUSED_ENTRY(gather_l2_f32_i32, gather_l2_rows_f32_i32, int32_t, Kind::F32)
UNFUSED_ENTRY(gather_l2_f32_i64, gather_l2_rows_f32_i64, int64_t, Kind::F32)
UNFUSED_ENTRY(gather_l2_bf16_i32, gather_l2_rows_bf16_i32, int32_t, Kind::BF16)
UNFUSED_ENTRY(gather_l2_bf16_i64, gather_l2_rows_bf16_i64, int64_t, Kind::BF16)
