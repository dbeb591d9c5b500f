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
// (~27 us at 3.35 TB/s), ~47 MB in bf16 and ~24 MB in int8 (~7.3 us);
// the unfused gather reads every lane's row, ~101 MB in f32 (~30 us). The
// arithmetic (3 flops per element, plus a multiply for int8) is far below
// the card's fp32 rate.
//
// Design: the f32 and bf16 forms and the unfused gathers give one warp
// to each candidate lane, the query row staged in shared memory. The
// filtered form tests the m attrs first (one lane per attr, __all_sync),
// so a lane that fails the predicate never reads its vector row. A row streams as
// coalesced 16-byte loads (4 f32 or 8 bf16 values; d=768 is 192 or 96
// loads), is widened to f32 in registers and reduces with a warp shuffle
// tree. These forms compute a row's distance with the one device function
// row_l2 and the same 16-byte-load rule, so on the same corpus, query and
// id their finite lanes are bitwise equal (the reference pins the same
// for its kernels). The blocked kernel gives a block of 8 warps to 8
// lanes of one query, staging the query once per block; the row-per-step
// kernel follows the TPU grid (B, C), one single-warp block per lane.
//
// The int8 form (gather_l2_filter_q8_kernel): an int8 row at d=768 is
// only 48 16-byte loads, so a warp per lane left half its lanes idle and
// each lane with a chain of dependent reads (id, attrs, row) and one or two
// loads in flight. A block of 128 threads instead owns 32 lanes of one
// query: it reads their ids in one coalesced load, tests the (lane, attr)
// pairs a thread each, writes +inf for the pad, out-of-range and failing
// lanes at once and lists the passing lanes in shared memory. Each
// half-warp then takes two listed rows at a time, issues all their 16-byte
// loads (3 a thread a row at d=768) and both scales before any
// arithmetic, and reduces the two rows with one transposing shuffle step
// and three plain ones. Row loads stream (evict first): a row is read
// once, and the ids, attrs and scales the next call reads stay in L2. The
// query is staged in the order the half-warps read it, so their shared
// loads are free of bank conflicts. int8 values become f32 by __byte_perm
// into the mantissa of 2^23 and one subtraction (exact, so equal to the
// I2F conversion it replaces, which issues at 16 a clock per SM on
// sm_90); each product __fmul_rn(v, s) is rounded on its own, then q - r
// and fmaf into an f32 sum, as the reference orders them. Its sum over a
// row runs in another order than row_l2's, so its lanes are held to the
// plain version within rtol 1e-5, atol 1e-3, and bitwise only where every
// partial sum is exact.
//
// The kernels allocate nothing; the wrapper sizes `out`. The int8 form's
// probe instance (gather_l2_filter_q8_i64_probe) adds clock64() phase
// stamps for chip_smoke.py; no wrapper launches it.

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

// ---- the int8 form -------------------------------------------------------

constexpr int kQ8Lanes = 32;        // candidate lanes a block owns
constexpr int kQ8Threads = 128;     // 8 half-warps, two rows each a round
constexpr int kQ8Rows = 2 * kQ8Threads / 16;   // listed rows a round
constexpr int kQ8Loads = 3;         // 16-byte loads a thread issues per row
                                    // per pass (768 bytes a row pass)

// Four int8 values (one 32-bit word, element 0 in byte 0) to f32 without an
// I2F: flipping the sign bits gives v + 128 as an unsigned byte, which
// __byte_perm places in the mantissa of 2^23 (0x4B000000); subtracting
// 2^23 + 128 leaves v. Both steps are exact, so each value equals
// static_cast<float>(v) bit for bit.
__device__ __forceinline__ float4 i8x4_to_f32(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  const float k = 8388736.f;
  return make_float4(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440)) - k,
                     __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7441)) - k,
                     __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7442)) - k,
                     __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7443)) - k);
}

// acc += sum over the 4 values of (q - __fmul_rn(v, s))^2, each product
// rounded on its own as the reference's dequant_rows writes it
__device__ __forceinline__ float q8_fma4(float4 q, float4 v, float s,
                                         float acc) {
  float t = q.x - __fmul_rn(v.x, s); acc = fmaf(t, t, acc);
  t = q.y - __fmul_rn(v.y, s); acc = fmaf(t, t, acc);
  t = q.z - __fmul_rn(v.z, s); acc = fmaf(t, t, acc);
  t = q.w - __fmul_rn(v.w, s); acc = fmaf(t, t, acc);
  return acc;
}

// The query's float4 f (16-byte row load j = f / 4, part u = f % 4) at the
// slot half-warp lane j % 16 reads in pass j / 48, load (j / 16) % 3: the
// 16 lanes of a half-warp read 16 consecutive float4s, free of bank
// conflicts.
__device__ __forceinline__ int q8_slot(int f) {
  const int j = f >> 2;
  return (((j >> 4) * 4 + (f & 3)) << 4) + (j & 15);
}

__device__ __forceinline__ long long stamp() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// Grid (ceil(C / 32) capped, B), 128 threads. A block owns 32 candidate
// lanes of one query: it stages the query and the lanes' ids, tests the
// (lane, attr) pairs a thread each, writes +inf for the pad, out-of-range
// and failing lanes and lists the passing ones; then each half-warp
// scores two listed rows at a time (two rounds for 32 listed rows), all
// their loads and scales issued before any arithmetic, and reduces both
// with one transposing shuffle step and three plain ones. `vec`: 16-byte
// row loads (d % 16 == 0 and the corpus 16-byte aligned), streaming
// (__ldcs: evict first, so the rows, read once, do not push the ids,
// attrs and scales out of L2); else byte loads. Probe: thread 0 writes
// per block [entry, staged, listed, cycles waiting on row loads, cycles
// of row arithmetic, exit] as clock64() values to probe[6 * block].
template <typename IdxT, bool Probe>
__global__ void __launch_bounds__(kQ8Threads)
gather_l2_filter_q8_kernel(const IdxT* __restrict__ idx,
                           const int8_t* __restrict__ corpus,
                           const float* __restrict__ scale,
                           const float* __restrict__ attrs,
                           const float* __restrict__ q,
                           const float* __restrict__ qlo,
                           const float* __restrict__ qhi,
                           float* __restrict__ out, int C, int N, int d,
                           int m, bool vec, long long* __restrict__ probe) {
  extern __shared__ float4 qs4[];
  __shared__ long long sid[kQ8Lanes];
  __shared__ int sfail[kQ8Lanes];
  __shared__ int slist[kQ8Lanes];
  __shared__ int snpass;
  float* qs = reinterpret_cast<float*>(qs4);
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  long long t_entry = 0, t_wait = 0, t_math = 0;
  if (Probe && tid == 0) t_entry = stamp();

  const float* qrow = q + (size_t)b * d;
  for (int e = tid; e < d; e += kQ8Threads)
    qs[vec ? 4 * q8_slot(e >> 2) + (e & 3) : e] = qrow[e];
  const float* lo = qlo + (size_t)b * m;
  const float* hi = qhi + (size_t)b * m;
  const int nv = d / 16;
  const int hw = tid >> 4, l16 = tid & 15;
  long long t_staged = 0, t_listed = 0;

  for (int c0 = blockIdx.x * kQ8Lanes; c0 < C; c0 += gridDim.x * kQ8Lanes) {
    __syncthreads();                 // the previous tile's list is consumed
    if (tid < kQ8Lanes) {
      const int c = c0 + tid;
      const long long id = c < C ? (long long)idx[(size_t)b * C + c] : -1;
      const bool ok = id >= 0 && id < N;
      sid[tid] = ok ? id : -1;
      sfail[tid] = !ok;
    }
    __syncthreads();
    if (Probe && tid == 0 && c0 == blockIdx.x * kQ8Lanes) t_staged = stamp();
    // one thread per (lane, attr); NaN fails every comparison
    for (int p = tid; p < kQ8Lanes * m; p += kQ8Threads) {
      const int l = p / m, a = p - l * m;
      const long long id = sid[l];
      if (id >= 0) {
        const float v = __ldg(attrs + id * m + a);
        if (!(v >= __ldg(lo + a) && v <= __ldg(hi + a))) sfail[l] = 1;
      }
    }
    __syncthreads();
    if (tid < 32) {
      int base = 0;
#pragma unroll
      for (int h = 0; h < kQ8Lanes / 32; ++h) {
        const int l = h * 32 + tid;
        const bool pass = !sfail[l];
        const unsigned bal = __ballot_sync(0xffffffffu, pass);
        if (pass)
          slist[base + __popc(bal & ((1u << tid) - 1u))] = l;
        else if (c0 + l < C)
          out[(size_t)b * C + c0 + l] = CUDART_INF_F;
        base += __popc(bal);
      }
      if (tid == 0) snpass = base;
    }
    __syncthreads();
    if (Probe && tid == 0 && c0 == blockIdx.x * kQ8Lanes) t_listed = stamp();

    const int npass = snpass;
    for (int k0 = 0; k0 < npass; k0 += kQ8Rows) {   // uniform in the block
      const int ka = k0 + hw, kb = k0 + kQ8Rows / 2 + hw;
      const bool ha = ka < npass, hb = kb < npass;
      const int la = ha ? slist[ka] : 0, lb = hb ? slist[kb] : 0;
      const int8_t* ra = corpus + (ha ? sid[la] : 0) * (long long)d;
      const int8_t* rb = corpus + (hb ? sid[lb] : 0) * (long long)d;
      const float sa = ha ? __ldg(scale + sid[la]) : 0.f;
      const float sb = hb ? __ldg(scale + sid[lb]) : 0.f;
      float acc_a = 0.f, acc_b = 0.f;
      if (vec) {
        const uint4* a16 = reinterpret_cast<const uint4*>(ra);
        const uint4* b16 = reinterpret_cast<const uint4*>(rb);
        for (int j0 = 0; j0 < nv; j0 += 16 * kQ8Loads) {
          long long t0 = 0;
          if (Probe && tid == 0) t0 = stamp();
          uint4 va[kQ8Loads], vb[kQ8Loads];
#pragma unroll
          for (int u = 0; u < kQ8Loads; ++u) {
            const int j = j0 + 16 * u + l16;
            va[u] = ha && j < nv ? __ldcs(a16 + j) : make_uint4(0, 0, 0, 0);
            vb[u] = hb && j < nv ? __ldcs(b16 + j) : make_uint4(0, 0, 0, 0);
          }
          if (Probe && tid == 0) {
            uint32_t z = __float_as_uint(sa) ^ __float_as_uint(sb);
#pragma unroll
            for (int u = 0; u < kQ8Loads; ++u)
              z ^= va[u].x ^ va[u].w ^ vb[u].x ^ vb[u].w;
            if (z == 0x9e3779b9u) probe[0] = 0;     // waits for every load
            const long long t1 = stamp();
            t_wait += t1 - t0;
            t0 = t1;
          }
#pragma unroll
          for (int u = 0; u < kQ8Loads; ++u) {
            const int j = j0 + 16 * u + l16;
            if (j < nv) {
              const float4* qj = qs4 + ((j >> 4) * 4 << 4) + l16;
              const uint32_t wa[4] = {va[u].x, va[u].y, va[u].z, va[u].w};
              const uint32_t wb[4] = {vb[u].x, vb[u].y, vb[u].z, vb[u].w};
#pragma unroll
              for (int w = 0; w < 4; ++w) {
                const float4 qv = qj[16 * w];
                acc_a = q8_fma4(qv, i8x4_to_f32(wa[w]), sa, acc_a);
                acc_b = q8_fma4(qv, i8x4_to_f32(wb[w]), sb, acc_b);
              }
            }
          }
          if (Probe && tid == 0) t_math += stamp() - t0;
        }
      } else {
        for (int j = l16; j < d; j += 16) {
          const float qj = qs[j];
          float t = qj - widen<Kind::I8>(ha ? ra[j] : (int8_t)0, sa);
          acc_a = fmaf(t, t, acc_a);
          t = qj - widen<Kind::I8>(hb ? rb[j] : (int8_t)0, sb);
          acc_b = fmaf(t, t, acc_b);
        }
      }
      // lanes 0-7 of a half-warp keep row a, lanes 8-15 row b
      const bool up = l16 & 8;
      float v = (up ? acc_b : acc_a) +
                __shfl_xor_sync(0xffffffffu, up ? acc_a : acc_b, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (l16 == 0 && ha) out[(size_t)b * C + c0 + la] = v;
      if (l16 == 8 && hb) out[(size_t)b * C + c0 + lb] = v;
    }
  }
  if (Probe) {
    __syncthreads();
    if (tid == 0) {
      long long* p = probe + 6 * ((size_t)blockIdx.y * gridDim.x + blockIdx.x);
      p[0] = t_entry; p[1] = t_staged; p[2] = t_listed;
      p[3] = t_wait; p[4] = t_math; p[5] = stamp();
    }
  }
}

template <typename IdxT, bool Probe>
int launch_q8(const void* idx, const void* corpus, const void* scale,
              const void* attrs, const void* q, const void* qlo,
              const void* qhi, void* out, int B, int C, int N, int d, int m,
              long long* probe, void* stream) {
  if (B == 0 || C == 0) return 0;
  const bool vec = use_vec<Kind::I8>(corpus, d);
  // the query in q8_slot order fills whole 16-row-load groups
  const size_t smem =
      (size_t)(vec ? (d + 255) / 256 * 256 : d) * sizeof(float);
  int e = allow_smem(gather_l2_filter_q8_kernel<IdxT, Probe>, smem);
  if (e != 0) return e;
  int gx = (C + kQ8Lanes - 1) / kQ8Lanes;
  if (gx > 65535) gx = 65535;
  dim3 grid(gx, B);
  gather_l2_filter_q8_kernel<IdxT, Probe><<<grid, kQ8Threads, smem,
                                            (cudaStream_t)stream>>>(
      (const IdxT*)idx, (const int8_t*)corpus, (const float*)scale,
      (const float*)attrs, (const float*)q, (const float*)qlo,
      (const float*)qhi, (float*)out, C, N, d, m, vec, probe);
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

// The int8 form's own kernel.
#define Q8_ENTRY(NAME, IDXT)                                                 \
  extern "C" int NAME(const void* idx, const void* corpus,                   \
                      const void* scale, const void* attrs, const void* q,   \
                      const void* qlo, const void* qhi, void* out, int B,    \
                      int C, int N, int d, int m, void* stream) {            \
    return launch_q8<IDXT, false>(idx, corpus, scale, attrs, q, qlo, qhi,    \
                                  out, B, C, N, d, m, nullptr, stream);      \
  }

Q8_ENTRY(gather_l2_filter_q8_i32, int32_t)
Q8_ENTRY(gather_l2_filter_q8_i64, int64_t)

// Its probe instance at the main path's int64 ids: per-block clock64()
// phase stamps into `probe`, for chip_smoke.py; no wrapper launches it.
extern "C" int gather_l2_filter_q8_i64_probe(
    const void* idx, const void* corpus, const void* scale, const void* attrs,
    const void* q, const void* qlo, const void* qhi, void* out, int B, int C,
    int N, int d, int m, void* probe, void* stream) {
  return launch_q8<int64_t, true>(idx, corpus, scale, attrs, q, qlo, qhi,
                                  out, B, C, N, d, m, (long long*)probe,
                                  stream);
}

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
