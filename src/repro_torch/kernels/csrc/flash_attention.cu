// flash_attention — full-sequence (prefill) GQA attention with an online
// softmax, causal and/or sliding-window.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` / `_kernel` in
// src/repro/kernels/flash_attention.py (reached through `ops.flash_attention`
// in src/repro/kernels/ops.py). Same function: for q [B,S,H,D] and k/v
// [B,S,KV,D], out[b,i,h] = sum_j softmax_j(s_ij) v[b,j,h/rep] with
// s_ij = (q[b,i,h] * D^-0.5) . k[b,j,h/rep], rep = H/KV. The mask comes from
// the absolute positions i, j in [0, S) (causal: j <= i; window > 0:
// j > i - window), never from explicit positions, like the TPU kernel's
// iota mask. Masked scores are NEG_INF (the TPU kernel's value, not -inf),
// softmax and accumulation are fp32, the output is in q's dtype.
//
// What bounds it on an H100: operations. At the chatglm3-6b prefill shape
// (B=2, S=4096, H=32, KV=2, D=128, causal) a call does ~275 GFLOP against
// ~143 MB of inputs and output, ~1900 flops per byte; in bf16 on the tensor
// cores the bound is ~0.28 ms. This kernel computes with fp32 FMAs on
// the CUDA cores (67 TFLOP/s peak), so it cannot beat ~4.1 ms there.
//
// Design (simple and right first):
//  - One thread block per (batch, KV head, tile of BM = 64 query rows). A
//    query row is a (position, head) pair: the block covers the HB query
//    heads that share the KV head (HB = the largest divisor of rep up to 64)
//    at P = 64 / HB consecutive positions, so each K/V tile it loads serves
//    all of them. No GQA repeat, no transpose, no padding of D in memory:
//    q, k and v are read where they lie, through their strides.
//  - K and V tiles of BK = 64 keys are staged in shared memory as fp32 (D
//    rounded up to DP in {64, 128, 256}, zero-padded); Q's tile, pre-scaled,
//    stays in shared memory for the whole key loop.
//  - 256 threads as 16 x 16: thread (ty, tx) owns 4 query rows; for the
//    scores it takes keys tx + 16c (c < 4), for the output columns
//    (16c + tx) * 4 .. + 3. The running max, denominator and the [4, DP/16]
//    accumulator stay in registers; row reductions are shuffles across the
//    16 tx lanes. The probabilities go through shared memory, reusing the K
//    tile once the scores are taken.
//  - Wholly masked key tiles are skipped: keys after the block's last
//    position when causal, keys before its first position's window. This is
//    exactly the TPU kernel's result: there, a fully masked tile either
//    follows an unmasked key and adds exp(NEG_INF - m) = 0, or precedes one
//    and its exp(0) terms are wiped by exp(NEG_INF - m_new) = 0; every row
//    has an unmasked key (the diagonal when causal, all later keys
//    otherwise). Tiles are scheduled latest positions first, the longest.
//
// This is the CUDA-core variant: it takes float32 (whose 2e-5 tolerance
// TF32 cannot hold), D in (128, 256] and views a TMA tensor map cannot
// describe. bf16 inputs the tensor cores can take go to
// flash_attention_wgmma.cu (the rule is `_flash_variant` in ops.py).
#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr float NEG_INF = -2.3819763e38f;  // the TPU kernel's mask value
constexpr int BM = 64;        // query rows (position, head) per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int RPT = 4;        // query rows per thread
constexpr int KPT = 4;        // keys per thread in the score tile

template <int DP>
struct Layout {
  static constexpr int LDQ = DP + 4;  // +4 floats: float4 reads without bank conflicts
  static constexpr int LDK = DP + 4;
  static constexpr int LDV = DP;
  static constexpr int LDP = BK + 4;
  static constexpr int Q = BM * LDQ, K = BK * LDK, V = BK * LDV;
  static constexpr size_t BYTES = sizeof(float) * (Q + K + V);
  static_assert(BM * LDP <= K, "the probabilities reuse the K tile");
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, DP <= 128 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int S, int H, int KV, int D, int HB, int P,
                       long long qsb, long long qss, long long qsh,
                       long long ksb, long long kss, long long ksh,
                       long long vsb, long long vss, long long vsh,
                       float scale, int causal, int window) {
  using L = Layout<DP>;
  constexpr int CG = DP / 64;  // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + L::Q;
  float* vs = ks + L::K;
  float* ps = ks;  // probabilities, once the scores of the tile are taken

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rep = H / KV, groups = rep / HB;
  const int kvh = blockIdx.x / groups;
  const int h0 = kvh * rep + (blockIdx.x % groups) * HB;
  const int b = blockIdx.y;
  const int p0 = (gridDim.z - 1 - blockIdx.z) * P;  // latest (longest) first
  const int n_pos = min(P, S - p0);
  const int rows = n_pos * HB;
  const int last = p0 + n_pos - 1;

  for (int i = tid; i < BM * DP; i += THREADS) {
    const int r = i / DP, d = i - r * DP;
    float x = 0.f;
    if (r < rows && d < D)
      x = to_f(q[b * qsb + (long long)(p0 + r / HB) * qss +
                 (long long)(h0 + r % HB) * qsh + d]) * scale;
    qs[r * L::LDQ + d] = x;
  }

  int qpos[RPT];
  float m[RPT], l[RPT], acc[RPT][4 * CG];
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    const int r = ty * RPT + rr;
    qpos[rr] = r < rows ? p0 + r / HB : last;  // pad rows: never written
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) acc[rr][c] = 0.f;
  }

  const int j_hi = causal ? last + 1 : S;
  int j_lo = window > 0 ? max(0, p0 - window + 1) : 0;
  j_lo -= j_lo % BK;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int j0 = j_lo; j0 < j_hi; j0 += BK) {
    __syncthreads();  // Q stored; the previous tile's P and V fully read
    for (int i = tid; i < BK * DP; i += THREADS) {
      const int t = i / DP, d = i - t * DP;
      const int j = j0 + t;
      float kx = 0.f, vx = 0.f;
      if (j < j_hi && d < D) {
        kx = to_f(kb[(long long)j * kss + d]);
        vx = to_f(vb[(long long)j * vss + d]);
      }
      ks[t * L::LDK + d] = kx;
      vs[t * L::LDV + d] = vx;
    }
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
      for (int c = 0; c < KPT; ++c) s[rr][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qa[RPT], kk[KPT];
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr)
        qa[rr] = *reinterpret_cast<const float4*>(qs + (ty * RPT + rr) * L::LDQ + d);
#pragma unroll
      for (int c = 0; c < KPT; ++c)
        kk[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * L::LDK + d);
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
          float x = s[rr][c];
          x = fmaf(qa[rr].x, kk[c].x, x);
          x = fmaf(qa[rr].y, kk[c].y, x);
          x = fmaf(qa[rr].z, kk[c].z, x);
          x = fmaf(qa[rr].w, kk[c].w, x);
          s[rr][c] = x;
        }
    }
    __syncthreads();  // every warp is done with the K tile: P overwrites it

#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const int i = qpos[rr];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        const int j = j0 + tx + 16 * c;
        const bool ok = j < S && (!causal || j <= i) && (window <= 0 || j > i - window);
        if (!ok) s[rr][c] = NEG_INF;
        mx = fmaxf(mx, s[rr][c]);
      }
      const float m_new = fmaxf(m[rr], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        const float p = expf(s[rr][c] - m_new);
        ps[(ty * RPT + rr) * L::LDP + tx + 16 * c] = p;
        sum += p;
      }
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + row_sum16(sum);
      m[rr] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * CG; ++c) acc[rr][c] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int t = 0; t < BK; t += 4) {
      float4 pr[RPT];
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr)
        pr[rr] = *reinterpret_cast<const float4*>(ps + (ty * RPT + rr) * L::LDP + t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 vv[CG];
#pragma unroll
        for (int g = 0; g < CG; ++g)
          vv[g] = *reinterpret_cast<const float4*>(vs + (t + e) * L::LDV + (16 * g + tx) * 4);
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) {
          const float p = comp(pr[rr], e);
#pragma unroll
          for (int g = 0; g < CG; ++g) {
            acc[rr][4 * g + 0] = fmaf(p, vv[g].x, acc[rr][4 * g + 0]);
            acc[rr][4 * g + 1] = fmaf(p, vv[g].y, acc[rr][4 * g + 1]);
            acc[rr][4 * g + 2] = fmaf(p, vv[g].z, acc[rr][4 * g + 2]);
            acc[rr][4 * g + 3] = fmaf(p, vv[g].w, acc[rr][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    const int r = ty * RPT + rr;
    if (r >= rows) continue;
    const float den = fmaxf(l[rr], 1e-30f);
    T* o = out + (((long long)b * S + p0 + r / HB) * H + h0 + r % HB) * D;
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = (16 * g + tx) * 4 + e;
        if (d < D) o[d] = from_f<T>(acc[rr][4 * g + e] / den);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int D, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  using L = Layout<DP>;
  auto kern = flash_attention_kernel<T, DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int rep = H / KV;
  int hb = rep < BM ? rep : BM;
  while (rep % hb) --hb;  // the largest divisor of rep up to BM
  const int P = BM / hb;
  const dim3 grid(KV * (rep / hb), B, (S + P - 1) / P);
  kern<<<grid, THREADS, L::BYTES, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, KV, D, hb, P,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int KV, int D, const long long* st, float scale,
               int causal, int window, cudaStream_t s) {
  if (D <= 64) return launch<T, 64>(q, k, v, out, B, S, H, KV, D, st, scale, causal, window, s);
  if (D <= 128) return launch<T, 128>(q, k, v, out, B, S, H, KV, D, st, scale, causal, window, s);
  return launch<T, 256>(q, k, v, out, B, S, H, KV, D, st, scale, causal, window, s);
}

}  // namespace

extern "C" {

// q [B,S,H,D], k/v [B,S,KV,D], each with unit stride along D and element
// strides (batch, position, head) in `strides` (q's three, k's, v's); out
// [B,S,H,D] contiguous. dtype: 0 = float32, 1 = bfloat16. The caller
// passes B, S, H, KV, D > 0, H % KV == 0 and D <= 256.
// Returns cudaGetLastError() after the launch.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int H, int KV, int D,
                    const long long* strides, float scale, int causal,
                    int window, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, B, S, H, KV, D, strides,
                                     scale, causal, window, s);
  return dispatch_d<float>(q, k, v, out, B, S, H, KV, D, strides, scale,
                           causal, window, s);
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
