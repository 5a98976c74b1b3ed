// paged_attention — one-token GQA decode over the HADES-paged KV pool.
//
// Replaces the Pallas TPU kernel `paged_attention_pallas` / `_kernel` in
// src/repro/kernels/paged_attention.py. Same function: for every lane b
// and query head, softmax(q . K^T * D^-0.5) V over the lane's KV blocks,
// found through block_tables (-1 = unused) in the pool's slots, with
// positions >= seq_lens[b] masked, plus the fused access bits
// touched[b, j] = (j * bt < seq_lens[b]) && (block_tables[b, j] >= 0).
//
// What bounds it on an H100: bytes. Each lane reads its live K/V blocks
// once (2 * ceil(len / bt) * bt * KV * D * 2 bytes in bf16) and does about
// 4 * H * D flops per token, far below the ~295 flops/byte where the tensor
// cores would become the limit.
//
// Design (the simple first version): one thread block per (lane, KV head),
// one warp per query head of the group (REP warps), fp32 arithmetic with
// an online softmax, like the TPU kernel's VMEM scratch. The block walks
// the lane's blocks in order and stops at the last block that holds a
// valid position, so it reads only the bytes the lane needs; each block's
// [bt, D] K and V tiles for this KV head are staged in shared memory once
// and shared by the REP warps. The pool is taken in its own layout
// without a copy: K and V are strided views of the pool rows, so the
// kernel gets the two base pointers and the slot stride. A lane with no
// valid position writes zeros (the TPU kernel returns a mean over slot 0
// there; kvcache.attend masks such lanes out either way).
//
// What it leaves on the table: with only B * KV blocks (16 on the
// chatglm3-6b serve path) most of the 132 SMs stay idle; split-KV decoding
// over several blocks per lane and tensor-core dot products are later work.
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

constexpr int MAX_D = 256;          // head_dim the per-lane registers hold
constexpr int PER_LANE = MAX_D / 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ tables, const int* __restrict__ lens,
    T* __restrict__ out, unsigned char* __restrict__ touched,
    int KV, int REP, int D, int BT, int MB, int n_slots,
    long long slot_stride, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [REP, D], pre-scaled
  float* ks = qs + REP * D;         // [BT, D]
  float* vs = ks + BT * D;          // [BT, D]
  float* ps = vs + BT * D;          // [REP, BT] scores of the current block

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = lens[b];
  const int* row = tables + (long long)b * MB;

  const T* qb = q + ((long long)b * KV * REP + (long long)h * REP) * D;
  for (int i = threadIdx.x; i < REP * D; i += blockDim.x)
    qs[i] = to_f(qb[i]) * scale;
  if (h == 0)
    for (int j = threadIdx.x; j < MB; j += blockDim.x)
      touched[(long long)b * MB + j] =
          (j * BT < len) && (row[j] >= 0) ? 1 : 0;

  float m = -INFINITY, l = 0.f;
  float acc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) acc[i] = 0.f;

  const int n_blocks = len <= 0 ? 0 : min(MB, (len + BT - 1) / BT);
  for (int j = 0; j < n_blocks; ++j) {
    int slot = row[j];
    if (slot < 0) continue;         // uniform across the block
    slot = min(slot, n_slots - 1);  // XLA gathers clamp; never read past the pool
    __syncthreads();                // previous tiles fully consumed
    const long long base = (long long)slot * slot_stride + (long long)h * D;
    for (int i = threadIdx.x; i < BT * D; i += blockDim.x) {
      const int t = i / D, d = i - t * D;
      const long long off = base + (long long)t * KV * D + d;
      ks[i] = to_f(k[off]);
      vs[i] = to_f(v[off]);
    }
    __syncthreads();

    const int n_valid = min(BT, len - j * BT);
    const float* qr = qs + warp * D;
    float* pr = ps + warp * BT;
    float bmax = -INFINITY;
    for (int t = 0; t < n_valid; ++t) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += qr[d] * ks[t * D + d];
      const float s = warp_sum(part);
      bmax = fmaxf(bmax, s);
      if (lane == 0) pr[t] = s;
    }
    __syncwarp();
    const float m_new = fmaxf(m, bmax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) acc[i] *= corr;
    for (int t = 0; t < n_valid; ++t) {
      const float p = expf(pr[t] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] += p * vs[t * D + d];
      }
    }
    __syncwarp();
    m = m_new;
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* o = out + ((long long)b * KV * REP + (long long)h * REP + warp) * D;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int d = lane + 32 * i;
    if (d < D) o[d] = from_f<T>(acc[i] * inv);
  }
}

}  // namespace

extern "C" {

size_t paged_attention_smem_bytes(int REP, int D, int BT) {
  return sizeof(float) * ((size_t)REP * D + 2 * (size_t)BT * D + (size_t)REP * BT);
}

// dtype: 0 = float32, 1 = bfloat16. The caller passes B, KV > 0.
// Returns cudaGetLastError() after the launch.
int paged_attention(const void* q, const void* k, const void* v,
                    const int* tables, const int* lens, void* out,
                    unsigned char* touched, int B, int KV, int REP, int D,
                    int BT, int MB, int n_slots, long long slot_stride,
                    float scale, int dtype, void* stream) {
  const dim3 grid(B, KV);
  const dim3 block(32 * REP);
  const size_t smem = paged_attention_smem_bytes(REP, D, BT);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    paged_attention_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, tables, lens, (__nv_bfloat16*)out, touched,
        KV, REP, D, BT, MB, n_slots, slot_stride, scale);
  } else {
    paged_attention_kernel<float><<<grid, block, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v, tables, lens,
        (float*)out, touched, KV, REP, D, BT, MB, n_slots, slot_stride, scale);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
