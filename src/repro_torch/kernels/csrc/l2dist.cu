// All-pairs squared L2 by the expansion |q|^2 + |c|^2 - 2 q.c, for Hopper
// (sm_90a), with an optional batch axis.
//
// Replaces: src/repro/kernels/l2dist.py:l2dist_qn_kernel (the Pallas TPU
// kernel the device graph builder reaches through ops.l2dist).
//
// Computes out[g, i, j] = |q[g, i]|^2 + |c[g, j]|^2 - 2 * sum_k q[g,i,k] c[g,j,k]
// for q (G, B, d), c (G, N, d) -> out (G, B, N), all f32.
//
// Bound on the H100: operations. The builder's candidate distances total
// about 2 * sum_levels sum_nodes |O(p)|^2 * d ~ 4 n^2 d flop (3.1e15 at
// n=1M, d=768): at least 46 s at the card's 67 TFLOP/s fp32 SIMT rate.
// Each output element reads 2d inputs, so above a few dozen rows per
// operand the tile reuse below makes memory irrelevant.
//
// Design: a shared-memory tiled SIMT fp32 GEMM. A 256-thread block owns a
// 64x64 output tile and walks d in 32-wide steps; each thread keeps a 4x4
// register tile (rows ty + 16i, columns tx + 16j, so the inner loop reads
// shared memory without bank conflicts). Both operand slabs are stored
// k-major with one pad column. The row norms come from the same slabs:
// threads 0..63 accumulate |q_i|^2 and threads 64..127 |c_j|^2 while the
// tile is resident, so the norms cost no extra global traffic. Tensor
// cores (TF32/bf16) would change the numbers and are left to a later
// change; this kernel stays full fp32 to match the plain version.

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
