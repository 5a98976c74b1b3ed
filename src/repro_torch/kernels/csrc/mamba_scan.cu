// mamba_scan — the selective-SSM recurrence h_t = a_t * h_{t-1} + b_t of a
// mamba1 layer, over every lane (b, c, n) of a, b [B, S, C, N] from h0
// [B, C, N]; writes every state h_all [B, S, C, N] and the last h_last
// [B, C, N], both fp32.
//
// Replaces the Pallas TPU kernel `mamba_scan_pallas` / `_kernel` in
// src/repro/kernels/mamba_scan.py (reached through `ops.mamba_scan` in
// src/repro/kernels/ops.py). That kernel walks the sequence as the
// innermost, sequential grid dimension and carries h in VMEM scratch from
// one chunk of steps to the next; its chunk and channel-tile sizes are VMEM
// tiling with no counterpart here. GPU blocks run in no order, so the
// carry lives in a register instead: each thread owns one lane and loops
// over the whole sequence.
//
// Arithmetic: inputs are read as fp32 (bf16 widened exactly), and each
// step is __fadd_rn(__fmul_rn(a, h), b): a rounded product, then a rounded
// sum, never a fused multiply-add. That is what the plain version in
// kernels/ref.py computes, so the two agree bit for bit.
//
// What bounds it on an H100: bytes. Per step a lane reads a and b and
// writes h: 2 * elt + 4 bytes for two fp32 operations. At the falcon-mamba
// prefill shape (B=2, S=4096, C=8192, N=16, fp32) a call moves 12.9 GB,
// 3.85 ms at 3.35 TB/s.
//
// Design (simple and right first):
//  - One thread per lane, 128 threads a block; (c, n) is the fastest index,
//    so a warp's loads and stores of one step are 128 contiguous bytes.
//    The prefill shape has 262,144 lanes: 2,048 blocks for 132 SMs.
//  - The loop over t loads UNROLL steps of a and b before the dependent
//    chain consumes them, so each thread keeps 2 * UNROLL loads in flight.
//  - Offsets are 64-bit: B * S * C * N passes 2^31 at B=4 of the prefill
//    shape.
//
// What it leaves on the table: for few lanes and long S (decode of one
// sequence, or small models) the card is underfilled; a scan split across
// S in two passes with a carry would fill it.
//
// mamba_scan_bwd — its gradient, which the TPU kernel never had (JAX does
// not differentiate the port's path; the trainer of the port does, through
// `ops._MambaScan`). From a, h0, the forward's h_all and the gradients dh_all
// [B, S, C, N] and dh_last [B, C, N] of its outputs, one reverse pass per
// lane with the carry c (dh_last at t = S - 1, then a_{t+1} * g_{t+1}):
//   g_t = dh_t + c,  da_t = g_t * h_{t-1} (h_{-1} = h0),  db_t = g_t,
//   dh0 = a_0 * g_0,
// each a rounded product or sum, never fused, so that it equals autograd
// through the plain loop (`ref.mamba_scan_bwd`) bit for bit; da and db are
// rounded to a's dtype (round to nearest even, as torch casts). It walks
// time backwards where the tensors lie: no flipped copies.
//
// What bounds it: bytes. Per step a lane reads a, h_{t-1} and dh_t and
// writes da and db: five [B, S, C, N] tensors (fp32: 20 bytes a step for
// four operations). At zamba2's mamba2 carry ([2, 32, 64, 5120] fp32) that
// is 0.125 ms at 3.35 TB/s; at falcon-mamba's prefill shape 6.4 ms. Same
// design as the forward: one thread per lane, UNROLL steps of loads in
// flight ahead of the dependent chain.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h_all,
                  float* __restrict__ h_last, long long lanes, long long cn,
                  int seq) {
  const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= lanes) return;
  const long long bi = lane / cn;
  const long long base = bi * (long long)seq * cn + (lane - bi * cn);
  const T* ap = a + base;
  const T* bp = b + base;
  float* hp = h_all + base;
  float h = h0[lane];
  int t = 0;
  for (; t + UNROLL <= seq; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long off = (long long)(t + u) * cn;
      av[u] = to_f(ap[off]);
      bv[u] = to_f(bp[off]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      hp[(long long)(t + u) * cn] = h;
    }
  }
  for (; t < seq; ++t) {
    const long long off = (long long)t * cn;
    h = __fadd_rn(__fmul_rn(to_f(ap[off]), h), to_f(bp[off]));
    hp[off] = h;
  }
  h_last[lane] = h;
}

__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
mamba_scan_bwd_kernel(const T* __restrict__ a, const float* __restrict__ h0,
                      const float* __restrict__ h_all,
                      const float* __restrict__ dh_all,
                      const float* __restrict__ dh_last, T* __restrict__ da,
                      T* __restrict__ db, float* __restrict__ dh0,
                      long long lanes, long long cn, int seq) {
  const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= lanes) return;
  const long long bi = lane / cn;
  const long long base = bi * (long long)seq * cn + (lane - bi * cn);
  const T* ap = a + base;
  const float* hp = h_all + base;
  const float* gp = dh_all + base;
  T* dap = da + base;
  T* dbp = db + base;
  float c = dh_last[lane];
  int t = seq - 1;
  // steps t, t-1, ..., t-UNROLL+1, all >= 1: h_{t-1} lies in h_all
  for (; t >= UNROLL; t -= UNROLL) {
    float av[UNROLL], hv[UNROLL], gv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long off = (long long)(t - u) * cn;
      av[u] = to_f(ap[off]);
      hv[u] = hp[off - cn];
      gv[u] = gp[off];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long off = (long long)(t - u) * cn;
      const float g = __fadd_rn(gv[u], c);
      from_f(__fmul_rn(g, hv[u]), dap + off);
      from_f(g, dbp + off);
      c = __fmul_rn(g, av[u]);
    }
  }
  for (; t >= 0; --t) {
    const long long off = (long long)t * cn;
    const float g = __fadd_rn(gp[off], c);
    const float h_prev = t > 0 ? hp[off - cn] : h0[lane];
    from_f(__fmul_rn(g, h_prev), dap + off);
    from_f(g, dbp + off);
    c = __fmul_rn(g, to_f(ap[off]));
  }
  dh0[lane] = c;
}

template <typename T>
void launch(const void* a, const void* b, const float* h0, float* h_all,
            float* h_last, long long lanes, long long cn, int seq,
            cudaStream_t s) {
  const long long blocks = (lanes + THREADS - 1) / THREADS;
  mamba_scan_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
      (const T*)a, (const T*)b, h0, h_all, h_last, lanes, cn, seq);
}

}  // namespace

extern "C" {

// a, b: [batch, seq, cn] contiguous (cn = C * N) in the dtype given by
// `dtype` (0 fp32, 1 bf16); h0, h_last: [batch, cn] fp32; h_all: [batch,
// seq, cn] fp32. Launches on every call; the caller passes batch, seq and
// cn > 0. Returns cudaGetLastError() after the launch.
int mamba_scan(const void* a, const void* b, const float* h0, float* h_all,
               float* h_last, int batch, int seq, long long cn, int dtype,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long lanes = (long long)batch * cn;
  if (dtype == 1)
    launch<__nv_bfloat16>(a, b, h0, h_all, h_last, lanes, cn, seq, s);
  else
    launch<float>(a, b, h0, h_all, h_last, lanes, cn, seq, s);
  return (int)cudaGetLastError();
}

// a: [batch, seq, cn] in the dtype given by `dtype` (0 fp32, 1 bf16); h0,
// dh_last, dh0: [batch, cn] fp32; h_all, dh_all: [batch, seq, cn] fp32; da,
// db: [batch, seq, cn] in a's dtype; all contiguous. Launches on every
// call; the caller passes batch, seq and cn > 0. Returns cudaGetLastError()
// after the launch.
int mamba_scan_bwd(const void* a, const float* h0, const float* h_all,
                   const float* dh_all, const float* dh_last, void* da,
                   void* db, float* dh0, int batch, int seq, long long cn,
                   int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long lanes = (long long)batch * cn;
  const unsigned blocks = (unsigned)((lanes + THREADS - 1) / THREADS);
  if (dtype == 1)
    mamba_scan_bwd_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        (const __nv_bfloat16*)a, h0, h_all, dh_all, dh_last,
        (__nv_bfloat16*)da, (__nv_bfloat16*)db, dh0, lanes, cn, seq);
  else
    mamba_scan_bwd_kernel<float><<<blocks, THREADS, 0, s>>>(
        (const float*)a, h0, h_all, dh_all, dh_last, (float*)da, (float*)db,
        dh0, lanes, cn, seq);
  return (int)cudaGetLastError();
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
