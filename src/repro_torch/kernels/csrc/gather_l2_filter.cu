// Predicate-fused gather + squared L2 over candidate ids, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gather_l2_filter.py:gather_l2_filter_blocked_kernel
// (the Pallas TPU kernel behind backend="pallas_gather_l2_filter").
//
// Computes, per lane (b, c) with id = idx[b, c]:
//   out[b, c] = sum_j (q[b, j] - corpus[id, j])^2   if 0 <= id < N and
//               all_a(qlo[b, a] <= attrs[id, a] <= qhi[b, a]),
//               +inf otherwise (pad lanes, out-of-range ids, failed
//               predicate; NaN attrs fail every comparison).
//
// Bound on the H100: bytes. Every surviving lane reads one d-float row
// and its m attrs once, and nothing is reused across lanes, so at the
// main path's B=256, C=128, d=768 a call moves ~101 MB: ~30 us at
// 3.35 TB/s. The arithmetic (3 flops per element) is far below the card's
// fp32 rate.
//
// Design: one warp per candidate lane, the query row staged once per
// block in shared memory. The warp tests the m attrs first (one lane per
// attr, __all_sync), so a lane that fails the predicate never reads its
// vector row. A passing row streams as coalesced 16-byte float4 loads
// (d=768 is 192 float4, six per lane) and reduces in f32 with a warp
// shuffle tree. The kernel allocates nothing; the wrapper sizes `out`.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

template <typename IdxT>
__global__ void gather_l2_filter_kernel(const IdxT* __restrict__ idx,
                                        const float* __restrict__ corpus,
                                        const float* __restrict__ attrs,
                                        const float* __restrict__ q,
                                        const float* __restrict__ qlo,
                                        const float* __restrict__ qhi,
                                        float* __restrict__ out,
                                        int C, int N, int d, int m) {
  extern __shared__ float4 qs4[];
  float* qs = reinterpret_cast<float*>(qs4);
  const int b = blockIdx.y;
  const float* qrow = q + (size_t)b * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) qs[j] = qrow[j];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool vec4 = (d & 3) == 0;
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
        const float* row = corpus + id * (long long)d;
        float acc = 0.f;
        if (vec4) {
          const float4* r4 = reinterpret_cast<const float4*>(row);
          for (int j = lane; j < (d >> 2); j += 32) {
            const float4 r = __ldg(r4 + j);
            const float4 v = qs4[j];
            float t = v.x - r.x; acc = fmaf(t, t, acc);
            t = v.y - r.y; acc = fmaf(t, t, acc);
            t = v.z - r.z; acc = fmaf(t, t, acc);
            t = v.w - r.w; acc = fmaf(t, t, acc);
          }
        } else {
          for (int j = lane; j < d; j += 32) {
            const float t = qs[j] - __ldg(row + j);
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

template <typename IdxT>
int launch(const void* idx, const void* corpus, const void* attrs,
           const void* q, const void* qlo, const void* qhi, void* out,
           int B, int C, int N, int d, int m, void* stream) {
  if (B == 0 || C == 0) return 0;
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gather_l2_filter_kernel<IdxT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int gx = (C + kWarps - 1) / kWarps;
  if (gx > 65535) gx = 65535;
  dim3 grid(gx, B);
  gather_l2_filter_kernel<IdxT><<<grid, kWarps * 32, smem,
                                  (cudaStream_t)stream>>>(
      (const IdxT*)idx, (const float*)corpus, (const float*)attrs,
      (const float*)q, (const float*)qlo, (const float*)qhi, (float*)out,
      C, N, d, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gather_l2_filter_i32(const void* idx, const void* corpus,
                                    const void* attrs, const void* q,
                                    const void* qlo, const void* qhi,
                                    void* out, int B, int C, int N, int d,
                                    int m, void* stream) {
  return launch<int32_t>(idx, corpus, attrs, q, qlo, qhi, out, B, C, N, d,
                         m, stream);
}

extern "C" int gather_l2_filter_i64(const void* idx, const void* corpus,
                                    const void* attrs, const void* q,
                                    const void* qlo, const void* qhi,
                                    void* out, int B, int C, int N, int d,
                                    int m, void* stream) {
  return launch<int64_t>(idx, corpus, attrs, q, qlo, qhi, out, B, C, N, d,
                         m, stream);
}
