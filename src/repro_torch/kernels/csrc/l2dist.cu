// Squared L2 by the expansion |q|^2 + |c|^2 - 2 q.c, for Hopper (sm_90a):
// all pairs (with an optional batch axis), and per-query candidate sets.
//
// Replaces: src/repro/kernels/l2dist.py:l2dist_qn_kernel (the Pallas TPU
// kernel the device graph builder reaches through ops.l2dist) and
// src/repro/kernels/l2dist.py:l2dist_qc_kernel (the per-query candidates
// form behind backend="pallas_l2", and ops.l2dist with a 3-D c).
//
// l2dist_qn computes out[g, i, j] = |q[g, i]|^2 + |c[g, j]|^2
// - 2 * sum_k q[g,i,k] c[g,j,k] for q (G, B, d), c (G, N, d) -> out
// (G, B, N), all f32.
//
// l2dist_qc computes, for q (B, d) f32 and c (B, C, d) f32 or bf16 (upcast),
// out[b, j] = sum over d-tiles t of width td of
// (|q[b]_t|^2 + |c[b, j]_t|^2) - 2 q[b]_t . c[b, j]_t, added tile by tile
// as the TPU kernel's k-loop accumulates its (qs + cs - 2 qc) steps.
//
// Bound on the H100. l2dist_qn: operations. The builder's candidate
// distances total about 2 * sum_levels sum_nodes |O(p)|^2 * d ~ 4 n^2 d
// flop (3.1e15 at n=1M, d=768): at least 46 s at the card's 67 TFLOP/s
// fp32 SIMT rate. Each output element reads 2d inputs, so above a few dozen
// rows per operand the tile reuse below makes memory irrelevant.
// l2dist_qc: bytes. Each candidate row is read once and used once (4 flops
// per element), so the (B, C, d) block dominates: at the graph strategy's
// B=256, C=E*c_n=128, d=768 that is 100.7 MB, ~30 us at 3.35 TB/s.
//
// Design: l2dist_qn is a shared-memory tiled SIMT fp32 GEMM. A 256-thread
// block owns a 64x64 output tile and walks d in 32-wide steps; each thread
// keeps a 4x4 register tile (rows ty + 16i, columns tx + 16j, so the inner
// loop reads shared memory without bank conflicts). Both operand slabs are
// stored k-major with one pad column. The row norms come from the same
// slabs: threads 0..63 accumulate |q_i|^2 and threads 64..127 |c_j|^2
// while the tile is resident, so the norms cost no extra global traffic.
// Tensor cores (TF32/bf16) would change the numbers and are left to a later
// change; this kernel stays full fp32 to match the plain version.
//
// l2dist_qc gives one warp to each candidate row, 8 warps a block over
// candidates of one query, the query row and its per-tile |q_t|^2 staged in
// shared memory once per block. For each d-tile the warp reads the row's
// slice with lane-strided coalesced loads, accumulates |c_t|^2 and q_t.c_t
// in f32 registers (fmaf), reduces both with an xor-shuffle tree and adds
// the tile's (qs + cs) - 2 qc to the row's sum. Full fp32, no tensor cores
// and no library call: the same arithmetic as the plain version, in
// another summation order within a tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32;

__global__ void __launch_bounds__(256)
l2dist_qn_kernel(const float* __restrict__ q, const float* __restrict__ c,
                 float* __restrict__ out, int B, int N, int d,
                 long long q_bs, long long c_bs, long long o_bs) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  __shared__ float qn[BM];
  __shared__ float cn[BN];

  const int g = blockIdx.z;
  q += g * q_bs;
  c += g * c_bs;
  out += g * o_bs;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float nacc = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int s = 0; s < (BM * BK) / 256; ++s) {
      const int e = tid + s * 256;
      const int r = e / BK, col = e % BK;
      const int gk = k0 + col;
      const int gm = m0 + r, gn = n0 + r;
      As[col][r] = (gm < B && gk < d) ? q[(size_t)gm * d + gk] : 0.f;
      Bs[col][r] = (gn < N && gk < d) ? c[(size_t)gn * d + gk] : 0.f;
    }
    __syncthreads();
    if (tid < BM) {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) nacc = fmaf(As[k][tid], As[k][tid], nacc);
    } else if (tid < BM + BN) {
      const int r = tid - BM;
#pragma unroll 8
      for (int k = 0; k < BK; ++k) nacc = fmaf(Bs[k][r], Bs[k][r], nacc);
    }
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < BM) qn[tid] = nacc;
  else if (tid < BM + BN) cn[tid - BM] = nacc;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N)
        out[(size_t)gm * N + gn] =
            (qn[ty + 16 * i] + cn[tx + 16 * j]) - 2.f * acc[i][j];
    }
  }
}

constexpr int kQcWarps = 8;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Grid (ceil(C / 8) capped, B); shared memory: q (d floats), then |q_t|^2
// of each of the ceil(d / td) tiles.
template <typename T>
__global__ void __launch_bounds__(kQcWarps * 32)
l2dist_qc_kernel(const float* __restrict__ q, const T* __restrict__ c,
                 float* __restrict__ out, int C, int d, int td) {
  extern __shared__ float qsh[];
  const int ntiles = (d + td - 1) / td;
  float* qtile = qsh + d;
  const int b = blockIdx.y;
  const float* qrow = q + (size_t)b * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) qsh[j] = qrow[j];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int t = warp; t < ntiles; t += kQcWarps) {
    const int te = min(d, (t + 1) * td);
    float qs = 0.f;
    for (int j = t * td + lane; j < te; j += 32) qs = fmaf(qsh[j], qsh[j], qs);
    qs = warp_sum(qs);
    if (lane == 0) qtile[t] = qs;
  }
  __syncthreads();

  for (int j0 = blockIdx.x * kQcWarps + warp; j0 < C;
       j0 += gridDim.x * kQcWarps) {
    const T* row = c + ((size_t)b * C + j0) * (size_t)d;
    float acc = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      const int te = min(d, (t + 1) * td);
      float cs = 0.f, qc = 0.f;
#pragma unroll 4
      for (int j = t * td + lane; j < te; j += 32) {
        const float v = widen(row[j]);
        cs = fmaf(v, v, cs);
        qc = fmaf(qsh[j], v, qc);
      }
      cs = warp_sum(cs);
      qc = warp_sum(qc);
      acc += (qtile[t] + cs) - 2.f * qc;
    }
    if (lane == 0) out[(size_t)b * C + j0] = acc;
  }
}

template <typename T>
int launch_qc(const void* q, const void* c, void* out, int B, int C, int d,
              int td, void* stream) {
  if (B == 0 || C == 0) return 0;
  if (B > 65535 || td < 1) return (int)cudaErrorInvalidConfiguration;
  const int ntiles = (d + td - 1) / td;
  const size_t smem = (size_t)(d + ntiles) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        l2dist_qc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int gx = (C + kQcWarps - 1) / kQcWarps;
  if (gx > 65535) gx = 65535;
  dim3 grid(gx, B);
  l2dist_qc_kernel<T><<<grid, kQcWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const T*)c, (float*)out, C, d, td);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int l2dist_qn_f32(const void* q, const void* c, void* out, int G,
                             int B, int N, int d, long long q_bs,
                             long long c_bs, long long o_bs, void* stream) {
  if (G == 0 || B == 0 || N == 0) return 0;
  if (G > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM, G);
  l2dist_qn_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)c, (float*)out, B, N, d, q_bs, c_bs,
      o_bs);
  return (int)cudaGetLastError();
}

extern "C" int l2dist_qc_f32(const void* q, const void* c, void* out, int B,
                             int C, int d, int td, void* stream) {
  return launch_qc<float>(q, c, out, B, C, d, td, stream);
}

extern "C" int l2dist_qc_bf16(const void* q, const void* c, void* out, int B,
                              int C, int d, int td, void* stream) {
  return launch_qc<__nv_bfloat16>(q, c, out, B, C, d, td, stream);
}
