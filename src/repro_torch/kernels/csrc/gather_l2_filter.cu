// Predicate-fused gather + squared L2 over candidate ids, for Hopper (sm_90a),
// over an f32 corpus, its bf16 replica or its int8 replica.
//
// Replaces: src/repro/kernels/gather_l2_filter.py:gather_l2_filter_blocked_kernel
// (the Pallas TPU kernel behind backend="pallas_gather_l2_filter", which the
// reference also runs on the bf16 replica) and
// src/repro/kernels/gather_l2_filter.py:gather_l2_filter_q8_blocked_kernel
// (its int8-replica form, quant="int8").
//
// Computes, per lane (b, c) with id = idx[b, c]:
//   out[b, c] = sum_j (q[b, j] - row(id)[j])^2   if 0 <= id < N and
//               all_a(qlo[b, a] <= attrs[id, a] <= qhi[b, a]),
//               +inf otherwise (pad lanes, out-of-range ids, failed
//               predicate; NaN attrs fail every comparison),
// where row(id) is corpus[id] (f32), float(corpus[id]) (bf16), or
// float(qcorpus[id]) * qscale[id] (int8, the product rounded on its own as
// the reference's dequant_rows writes it, then q - row). Sums are f32.
//
// Bound on the H100: bytes. Every surviving lane reads one row (4d bytes
// f32, 2d bf16, d + 4 int8 with its scale) and its m attrs once, and
// nothing is reused across lanes, so at the main path's B=256, C=128,
// d=768 with ~90% of lanes passing a call moves ~92 MB in f32 (~27 us at
// 3.35 TB/s), ~47 MB in bf16 and ~24 MB in int8. The arithmetic (3 flops
// per element, plus a multiply for int8) is far below the card's fp32 rate.
//
// Design: one warp per candidate lane, the query row staged once per
// block in shared memory. The warp tests the m attrs first (one lane per
// attr, __all_sync), so a lane that fails the predicate never reads its
// vector row. A passing row streams as coalesced 16-byte loads (4 f32,
// 8 bf16 or 16 int8 values; d=768 is 192, 96 or 48 loads), is widened to
// f32 in registers and reduces with a warp shuffle tree. One template over
// the element type serves the three corpora, so the f32 arithmetic is the
// same instruction sequence as before the replicas existed. The kernel
// allocates nothing; the wrapper sizes `out`.

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

template <typename IdxT, Kind K>
__global__ void gather_l2_filter_kernel(const IdxT* __restrict__ idx,
                                        const typename Elem<K>::T* __restrict__ corpus,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ attrs,
                                        const float* __restrict__ q,
                                        const float* __restrict__ qlo,
                                        const float* __restrict__ qhi,
                                        float* __restrict__ out,
                                        int C, int N, int d, int m, bool vec) {
  using T = typename Elem<K>::T;
  constexpr int V = Elem<K>::V;
  extern __shared__ float4 qs4[];
  float* qs = reinterpret_cast<float*>(qs4);
  const int b = blockIdx.y;
  const float* qrow = q + (size_t)b * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) qs[j] = qrow[j];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* lo = qlo + (size_t)b * m;
  const float* hi = qhi + (size_t)b * m;

  for (int c = blockIdx.x * kWarps + warp; c < C; c += gridDim.x * kWarps) {
    const long long id = (long long)idx[(size_t)b * C + c];
    float res = CUDART_INF_F;
    if (id >= 0 && id < N) {          // uniform across the warp
      bool ok = true;
      for (int a = lane; a < m; a += 32) {
        const float v = attrs[id * m + a];
        ok = ok && (v >= lo[a]) && (v <= hi[a]);
      }
      if (__all_sync(0xffffffffu, ok)) {
        const T* row = corpus + id * (long long)d;
        const float s = K == Kind::I8 ? __ldg(scale + id) : 1.f;
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
        res = acc;
      }
    }
    if (lane == 0) out[(size_t)b * C + c] = res;
  }
}

template <typename IdxT, Kind K>
int launch(const void* idx, const void* corpus, const void* scale,
           const void* attrs, const void* q, const void* qlo, const void* qhi,
           void* out, int B, int C, int N, int d, int m, void* stream) {
  if (B == 0 || C == 0) return 0;
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gather_l2_filter_kernel<IdxT, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // 16-byte row loads need every row start on a 16-byte boundary
  const bool vec = d % Elem<K>::V == 0 && ((uintptr_t)corpus & 15) == 0;
  int gx = (C + kWarps - 1) / kWarps;
  if (gx > 65535) gx = 65535;
  dim3 grid(gx, B);
  gather_l2_filter_kernel<IdxT, K><<<grid, kWarps * 32, smem,
                                     (cudaStream_t)stream>>>(
      (const IdxT*)idx, (const typename Elem<K>::T*)corpus,
      (const float*)scale, (const float*)attrs, (const float*)q,
      (const float*)qlo, (const float*)qhi, (float*)out, C, N, d, m, vec);
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
    return launch<IDXT, KIND>(idx, corpus, scale, attrs, q, qlo, qhi, out,   \
                              B, C, N, d, m, stream);                        \
  }

GATHER_ENTRY(gather_l2_filter_f32_i32, int32_t, Kind::F32)
GATHER_ENTRY(gather_l2_filter_f32_i64, int64_t, Kind::F32)
GATHER_ENTRY(gather_l2_filter_bf16_i32, int32_t, Kind::BF16)
GATHER_ENTRY(gather_l2_filter_bf16_i64, int64_t, Kind::BF16)
GATHER_ENTRY(gather_l2_filter_q8_i32, int32_t, Kind::I8)
GATHER_ENTRY(gather_l2_filter_q8_i64, int64_t, Kind::I8)
