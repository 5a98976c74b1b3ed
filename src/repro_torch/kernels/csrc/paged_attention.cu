// paged_attention — one-token GQA decode over the HADES-paged KV pool.
//
// Replaces the Pallas TPU kernel `paged_attention_pallas` / `_kernel` in
// src/repro/kernels/paged_attention.py. Same function: for every lane b
// and query head, softmax(q . K^T * D^-0.5) V over the lane's KV pages,
// found through block_tables (-1 = unused) in the pool's slots (clamped to
// n_slots - 1, as XLA's gather clamps), with positions >= seq_lens[b]
// masked, plus the fused access bits
// touched[b, j] = (j * bt < seq_lens[b]) && (block_tables[b, j] >= 0).
// A lane with no valid position gets zeros (the TPU kernel returns a mean
// over slot 0 there; kvcache.attend masks such lanes out either way).
//
// What bounds it on an H100: bytes. Each lane reads its live K/V pages
// once (2 * len * KV * D * 2 bytes in bf16) and does about 4 * H * D flops
// per token, far below the ~295 flops/byte where the tensor cores would
// become the limit. At the chatglm3-6b serve shape (B=8, 2 KV heads, up to
// 32 pages of 16 tokens) the bytes take under a microsecond, so what a
// call costs is latency: enough blocks in flight, short dependent chains.
//
// Design: split-KV decoding, then a combine pass.
//  * Split kernel: one block per (split s, group g of KV head h, lane b):
//    grid (n_splits, KV * G, B). Split s covers pages
//    [s * pps, (s + 1) * pps); group g covers the query heads
//    [g * RG, min(REP, (g + 1) * RG)) of KV head h. The wrapper picks
//    n_splits (ops._paged_splits) and (G, RG) (ops._paged_groups) from
//    static shapes only (B, KV, REP, D, MB and the SM count, never
//    seq_lens, so no host sync and a launch shape a CUDA graph can
//    capture): about 2 * n_SMs blocks, 256 at the serve shape instead of
//    16. G = 1 unless the query group does not fit one block (the
//    tensor-core kernel past REP 16, or 32 with D <= 128; the CUDA-core one
//    past 32 heads): granite's REP 48 runs as three 16-head groups on the
//    tensor cores, two of 24 on the CUDA cores, and each group reads the
//    KV head's pages again, which a kernel bound by latency affords. A
//    block whose range starts at or past the lane's length writes an empty
//    partial (m = NEG_INF, l = 0) and returns. Each block writes fp32
//    (m, l, the unnormalised acc[rows, D]) of its rows into scratch that
//    the wrapper allocates, [B, KV, n_splits, REP] rows whatever G is.
//  * Combine kernel: one block per (query row, KV head, lane) rescales the
//    partials by exp(m_s - m_max), sums them and divides by max(l, 1e-30),
//    reading the splits' acc with independent loads. A split
//    with l = 0 (no valid key) adds nothing and its acc is never read, so
//    an empty lane gives 0, never NaN: m is the finite NEG_INF of the TPU
//    kernel, and every masked key sets p = 0 explicitly (a finite NEG_INF
//    alone would give exp(NEG_INF - NEG_INF) = 1 for each masked key of an
//    all-masked split). The lane's first block writes its MB access bits,
//    so they are exact also for pages no split read.
//  * Tensor cores (bf16, D % 16 == 0, D <= 256, any REP): a block's rows
//    are RG heads of one token (RG = REP = 16 on chatglm3-6b, 16 a group on
//    granite), exactly the M of mma.sync m16n8k16 (RG in (16, 32], which
//    needs D <= 128, takes two m-tiles; rows past RG are zero). A warp
//    holds ceil(RG / 16) * 16 x D fp32 accumulators, at most 128 a thread,
//    which is why larger groups are cut. wgmma is not used: it needs 64 rows,
//    which would have to come from four lanes that read different pages.
//    Each warp of a block takes every NW-th page of the split with its own
//    (m, l, acc); Q and pages arrive by cp.async, 16 bytes a thread, into a
//    two-stage ring per warp (a K or V row of one KV head is D * 2 = 256
//    contiguous bytes at D = 128, 16 threads a row). TMA is not used: the
//    pages are gathered 4 KB pieces at addresses the block reads from the
//    table, so a tensor map would describe one page per copy and save
//    nothing over cp.async. Q.K^T takes Q (in shared memory) and K by
//    ldmatrix (the row-major K page is the .col B operand); the fp32
//    scores are scaled by D^-0.5 after the product (rounding q * scale to
//    bf16 would add an error the plain version does not have); the online
//    softmax runs per row on the accumulator layout (a row's 4 threads
//    reduce with 2 shuffles); P enters P.V (V by ldmatrix.trans, the
//    accumulator fp32) as two bf16 A operands, hi = bf16(P) and
//    lo = bf16(P - hi), so P keeps about 16 significant bits: with P
//    rounded once to bf16, chip_smoke's teacher-forced 2-layer serve window
//    put the logits 0.063 from the plain path, over its 5e-2 gate (the fp32
//    kernel this replaced: 0.0391), and the second product costs little in
//    a kernel bound by latency. A page of bt < 16
//    tokens is padded to 16 rows that stay zero in shared memory (a stale
//    NaN there would poison P.V even at P = 0). Rows are padded to D + 8
//    elements so that ldmatrix's eight 16-byte rows fall in distinct
//    banks. The warps merge their partials through shared memory.
//  * CUDA cores (fp32 and every other input): the same split/combine
//    grid; a block of RG <= 32 warps, one per query head of its group,
//    stages each page's K/V in fp32 shared memory and takes the dot
//    products with FMAs and a warp reduction (warps past the group's last
//    head, in a smaller last group, only help stage).
//
// The kernel this replaced ran one block per (lane, KV head) over
// all of the lane's pages, one warp per query head, one token's dot
// product at a time: 0.2074 ms of device time at B=8 H=32 KV=2 D=128 bt=16
// MB=32 bf16 (2168 live tokens) against SDPA's 0.0314 ms on the gathered
// K/V, and 0.0324 ms per launch on the serve path (chip_smoke, NVIDIA H100
// 80GB HBM3, 700.00 W).
#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG_INF = -2.3819763e38f;  // the TPU kernels' mask value
constexpr int MAX_D = 256;
constexpr int PER_LANE = MAX_D / 32;
constexpr int MMA_WARPS_MAX = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Partial index of (lane b, KV head h, split s, row r).
__device__ __forceinline__ long long part_row(int b, int h, int s, int r,
                                              int KV, int S, int REP) {
  return (((long long)b * KV + h) * S + s) * REP + r;
}

// ---------------------------------------------------------------------------
// PTX helpers (sm_80+ instructions; the library is built for sm_90a)
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x, y) as two bf16 pairs, hi = bf16(x, y) and lo = bf16((x, y) - hi), so
// that hi + lo keeps about 16 significant bits of each (x is the low half)
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// Shared memory of the tensor-core split kernel: Q [MT*16, D+8] bf16, then
// NW rings of 2 stages x {K, V} x [T, D+8] bf16 (T = bt rounded up to 16),
// then the warps' (m, l) [NW, MT*16] fp32 each. The merge reuses the rings
// for the warps' fp32 acc [NW, MT*16, D], which is never larger.
size_t mma_smem_bytes(int MT, int D, int BT, int NW) {
  const size_t ld = D + 8, t = (BT + 15) / 16 * 16;
  return 2 * ld * (MT * 16 + 4 * NW * t) + 8 * (size_t)NW * MT * 16;
}

size_t fma_smem_bytes(int REP, int D, int BT) {
  return sizeof(float) * ((size_t)REP * D + 2 * (size_t)BT * D + (size_t)REP * BT);
}

// Shared memory of a split block of RG rows (ops._paged_smem computes the
// same).
size_t split_smem_bytes(int tensor_cores, int RG, int D, int BT, int NW) {
  return tensor_cores ? mma_smem_bytes(RG > 16 ? 2 : 1, D, BT, NW)
                      : fma_smem_bytes(RG, D, BT);
}

// The block's KV head and its rows [r0, r0 + nr) of that head's REP.
struct Group {
  int h, r0, nr;
};
__device__ __forceinline__ Group block_group(int REP, int RG) {
  const int G = (REP + RG - 1) / RG;
  const int h = blockIdx.y / G, r0 = (blockIdx.y - h * G) * RG;
  return {h, r0, min(RG, REP - r0)};
}

// ---------------------------------------------------------------------------
// split kernel, tensor cores (bf16)
// ---------------------------------------------------------------------------
template <int DMAX, int MT>
__global__ void __launch_bounds__(32 * MMA_WARPS_MAX)
paged_attention_split_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ tables,
    const int* __restrict__ lens, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int KV, int REP,
    int RG, int D, int BT, int MB, int PPS, int n_slots,
    long long slot_stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Group grp = block_group(REP, RG);
  const int h = grp.h, r0 = grp.r0, NR = grp.nr;
  const int s = blockIdx.x, b = blockIdx.z, S = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NW = blockDim.x >> 5;
  const int page0 = s * PPS;
  const int* row = tables + (long long)b * MB;
  // the warp's first table entry loads beside the length, not after it
  const int len = lens[b];
  const int slot0 = page0 + warp < MB ? row[page0 + warp] : -1;
  if (page0 * BT >= len) {  // covers len <= 0 too
    for (int r = tid; r < NR; r += blockDim.x) {
      const long long i = part_row(b, h, s, r0 + r, KV, S, REP);
      part_m[i] = NEG_INF;
      part_l[i] = 0.f;
    }
    return;
  }
  const int n_pages = (len + BT - 1) / BT;
  const int p_end = min(min(page0 + PPS, MB), n_pages);
  const int LD = D + 8;
  const int T = (BT + 15) / 16 * 16;
  const int ring = 4 * T * LD;  // elements of one warp's ring
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* rings = qs + MT * 16 * LD;
  __nv_bfloat16* mine = rings + warp * ring;  // [stage][K|V][T][LD]
  float* ml = reinterpret_cast<float*>(rings + NW * ring);  // [NW][2][MT*16]

  // the group's Q rows by cp.async, zero past NR; this warp's pad rows
  // [BT, T) of every tile zero
  const int chunks = D / 8;  // 16-byte pieces of a row
  const __nv_bfloat16* qb = q + (((long long)b * KV + h) * REP + r0) * D;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < NR * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i - r * chunks;
    cp_async16(smem_addr(qs + r * LD + c * 8), qb + (long long)r * D + c * 8);
  }
  for (int i = tid; i < (MT * 16 - NR) * D; i += blockDim.x)
    qs[(NR + i / D) * LD + i % D] = zero;
  for (int i = lane; i < 4 * (T - BT) * D; i += 32) {
    const int tile = i / ((T - BT) * D), rest = i - tile * (T - BT) * D;
    const int t = BT + rest / D, d = rest % D;
    mine[tile * T * LD + t * LD + d] = zero;
  }
  auto load_page = [&](int slot, int stage) {
    if (slot < 0) return;
    slot = min(slot, n_slots - 1);  // XLA gathers clamp; never read past the pool
    const long long base = (long long)slot * slot_stride + (long long)h * D;
    __nv_bfloat16* kt = mine + stage * 2 * T * LD;
    __nv_bfloat16* vt = kt + T * LD;
    for (int i = lane; i < BT * chunks; i += 32) {
      const int t = i / chunks, c = i - t * chunks;
      const long long off = base + (long long)t * KV * D + c * 8;
      cp_async16(smem_addr(kt + t * LD + c * 8), k + off);
      cp_async16(smem_addr(vt + t * LD + c * 8), v + off);
    }
  };

  float acc[MT][DMAX / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int dn = 0; dn < DMAX / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dn][e] = 0.f;
  float m_run[MT][2], l_run[MT][2];  // rows g and g + 8 of each m-tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    m_run[mt][0] = m_run[mt][1] = NEG_INF, l_run[mt][0] = l_run[mt][1] = 0.f;

  const int g = lane >> 2, qd = lane & 3;
  // Q and each warp's first page arrive in one group; Q is the block's
  int stage = 0;
  if (page0 + warp < p_end) load_page(slot0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // Q and the pad rows are in place
  for (int j = page0 + warp; j < p_end; j += NW, stage ^= 1) {
    if (j + NW < p_end) load_page(row[j + NW], stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    if (row[j] >= 0) {
      const __nv_bfloat16* kt = mine + stage * 2 * T * LD;
      const __nv_bfloat16* vt = kt + T * LD;
      const int n_valid = min(BT, len - j * BT);
      for (int c0 = 0; c0 < n_valid; c0 += 16) {
        // S = Q . K^T over 16 tokens: two n-tiles of 8
        float sc[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[mt][nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DMAX / 16; ++kk) {
          if (kk * 16 < D) {
            unsigned kb[4];
            const int mi = lane >> 3;
            ldsm_x4(smem_addr(kt + (c0 + (mi >> 1) * 8 + (lane & 7)) * LD +
                              kk * 16 + (mi & 1) * 8), kb);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              unsigned qa[4];
              ldsm_x4(smem_addr(qs + (mt * 16 + (lane & 7) + (mi & 1) * 8) * LD +
                                kk * 16 + (mi >> 1) * 8), qa);
              mma_bf16(sc[mt][0], qa, kb[0], kb[1]);
              mma_bf16(sc[mt][1], qa, kb[2], kb[3]);
            }
          }
        }
        // online softmax per row; a row's 4 threads share g
        unsigned pa[MT][4], pb[MT][4];  // P = pa + pb, each bf16
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float p[2][2];
            float mx = NEG_INF;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int t = c0 + nt * 8 + 2 * qd + e;
                const float x = sc[mt][nt][2 * hr + e] * scale;
                p[nt][e] = x;
                if (t < n_valid) mx = fmaxf(mx, x);
              }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_run[mt][hr], mx);
            const float corr = expf(m_run[mt][hr] - m_new);
            m_run[mt][hr] = m_new;
            float sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int t = c0 + nt * 8 + 2 * qd + e;
                p[nt][e] = t < n_valid ? expf(p[nt][e] - m_new) : 0.f;
                sum += p[nt][e];
              }
            l_run[mt][hr] = l_run[mt][hr] * corr + sum;
#pragma unroll
            for (int dn = 0; dn < DMAX / 8; ++dn) {
              acc[mt][dn][2 * hr] *= corr;
              acc[mt][dn][2 * hr + 1] *= corr;
            }
            // A fragments of P: a0/a2 hold row g, a1/a3 row g + 8
            split_bf16(p[0][0], p[0][1], pa[mt][hr], pb[mt][hr]);
            split_bf16(p[1][0], p[1][1], pa[mt][2 + hr], pb[mt][2 + hr]);
          }
        }
        // acc += P . V: V [16 tokens, D] by ldmatrix.trans, 16 columns a
        // step, P as its hi and lo bf16 parts
#pragma unroll
        for (int dp = 0; dp < DMAX / 16; ++dp) {
          if (dp * 16 < D) {
            unsigned vb[4];
            const int mi = lane >> 3;
            ldsm_x4_t(smem_addr(vt + (c0 + (mi & 1) * 8 + (lane & 7)) * LD +
                                dp * 16 + (mi >> 1) * 8), vb);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][2 * dp], pa[mt], vb[0], vb[1]);
              mma_bf16(acc[mt][2 * dp], pb[mt], vb[0], vb[1]);
              mma_bf16(acc[mt][2 * dp + 1], pa[mt], vb[2], vb[3]);
              mma_bf16(acc[mt][2 * dp + 1], pb[mt], vb[2], vb[3]);
            }
          }
        }
      }
    }
    __syncwarp();  // this stage is consumed before the next load lands in it
  }

  // a row's l from its 4 threads
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = l_run[mt][hr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_run[mt][hr] = l;
    }
  cp_async_wait<0>();
  const long long pr0 = part_row(b, h, s, r0, KV, S, REP);
  float* out_acc = part_acc + pr0 * D;
  if (NW == 1) {  // the warp's partial is the block's: straight from registers
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = mt * 16 + g + 8 * hr;
        if (r >= NR) continue;
        if (qd == 0) {
          part_m[pr0 + r] = m_run[mt][hr];
          part_l[pr0 + r] = l_run[mt][hr];
        }
#pragma unroll
        for (int dn = 0; dn < DMAX / 8; ++dn)
          if (dn * 8 < D)
            *reinterpret_cast<float2*>(out_acc + r * D + dn * 8 + 2 * qd) =
                make_float2(acc[mt][dn][2 * hr], acc[mt][dn][2 * hr + 1]);
      }
    return;
  }
  // several warps: (m, l) of every row through shared memory, each warp's
  // acc scaled by exp(m_w - m_max) into its own slice, then summed
  __syncthreads();  // every warp is done with the rings
  const int R = MT * 16;
  float* accs = reinterpret_cast<float*>(rings);  // [NW][R][D]
  float* wacc = accs + (long long)warp * R * D;
  if (qd == 0)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = mt * 16 + g + 8 * hr;
        ml[(warp * 2 + 0) * R + r] = m_run[mt][hr];
        ml[(warp * 2 + 1) * R + r] = l_run[mt][hr];
      }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = mt * 16 + g + 8 * hr;
      float mm = NEG_INF;
      for (int w = 0; w < NW; ++w)
        if (ml[(w * 2 + 1) * R + r] > 0.f) mm = fmaxf(mm, ml[w * 2 * R + r]);
      float l = 0.f;
      for (int w = 0; w < NW; ++w) {
        const float lw = ml[(w * 2 + 1) * R + r];
        if (lw > 0.f) l += expf(ml[w * 2 * R + r] - mm) * lw;
      }
      // a warp that saw no valid key adds nothing (its acc is 0)
      const float wt = l_run[mt][hr] > 0.f ? expf(m_run[mt][hr] - mm) : 0.f;
      if (warp == 0 && qd == 0 && r < NR) {
        part_m[pr0 + r] = mm;
        part_l[pr0 + r] = l;
      }
#pragma unroll
      for (int dn = 0; dn < DMAX / 8; ++dn)
        if (dn * 8 < D)
          *reinterpret_cast<float2*>(wacc + r * D + dn * 8 + 2 * qd) =
              make_float2(acc[mt][dn][2 * hr] * wt, acc[mt][dn][2 * hr + 1] * wt);
    }
  __syncthreads();
  const float4* a4 = reinterpret_cast<const float4*>(accs);
  float4* o4 = reinterpret_cast<float4*>(out_acc);
  const int n4 = NR * D / 4, slice4 = R * D / 4;
  for (int i = tid; i < n4; i += blockDim.x) {
    float4 sum = a4[i];
    for (int w = 1; w < NW; ++w) {
      const float4 x = a4[w * slice4 + i];
      sum.x += x.x, sum.y += x.y, sum.z += x.z, sum.w += x.w;
    }
    o4[i] = sum;
  }
}

// ---------------------------------------------------------------------------
// split kernel, CUDA cores (fp32 and what the tensor-core kernel does not take)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void paged_attention_split_fma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ tables, const int* __restrict__ lens,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int KV, int REP, int RG, int D, int BT,
    int MB, int PPS, int n_slots, long long slot_stride, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;          // [RG, D]
  float* ks = qs + RG * D;   // [BT, D]
  float* vs = ks + BT * D;   // [BT, D]
  float* ps = vs + BT * D;   // [RG, BT] scores of the current page

  const Group grp = block_group(REP, RG);
  const int h = grp.h, NR = grp.nr;
  const int s = blockIdx.x, b = blockIdx.z, S = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool mine = warp < NR;  // a warp past the group's rows only stages
  const int len = lens[b];
  const int page0 = s * PPS;
  const long long pr = part_row(b, h, s, grp.r0 + warp, KV, S, REP);
  if (page0 * BT >= len) {
    if (lane == 0 && mine) {
      part_m[pr] = NEG_INF;
      part_l[pr] = 0.f;
    }
    return;
  }
  const int p_end = min(min(page0 + PPS, MB), (len + BT - 1) / BT);
  const int* row = tables + (long long)b * MB;
  const T* qb = q + (((long long)b * KV + h) * REP + grp.r0) * D;
  for (int i = threadIdx.x; i < NR * D; i += blockDim.x) qs[i] = to_f(qb[i]);

  float m = NEG_INF, l = 0.f;
  float acc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) acc[i] = 0.f;

  for (int j = page0; j < p_end; ++j) {
    int slot = row[j];
    if (slot < 0) continue;         // uniform across the block
    slot = min(slot, n_slots - 1);  // XLA gathers clamp; never read past the pool
    __syncthreads();                // previous tiles fully consumed (and Q staged)
    const long long base = (long long)slot * slot_stride + (long long)h * D;
    for (int i = threadIdx.x; i < BT * D; i += blockDim.x) {
      const int t = i / D, d = i - t * D;
      const long long off = base + (long long)t * KV * D + d;
      ks[i] = to_f(k[off]);
      vs[i] = to_f(v[off]);
    }
    __syncthreads();
    if (!mine) continue;

    const int n_valid = min(BT, len - j * BT);
    const float* qr = qs + warp * D;
    float* prow = ps + warp * BT;
    float pmax = NEG_INF;
    for (int t = 0; t < n_valid; ++t) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += qr[d] * ks[t * D + d];
      const float sc = warp_sum(part) * scale;
      pmax = fmaxf(pmax, sc);
      if (lane == 0) prow[t] = sc;
    }
    __syncwarp();
    const float m_new = fmaxf(m, pmax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) acc[i] *= corr;
    for (int t = 0; t < n_valid; ++t) {
      const float p = expf(prow[t] - m_new);
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

  if (!mine) return;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int d = lane + 32 * i;
    if (d < D) part_acc[pr * D + d] = acc[i];
  }
  if (lane == 0) {
    part_m[pr] = m;
    part_l[pr] = l;
  }
}

// ---------------------------------------------------------------------------
// combine kernel: one block per (row r, KV head h, lane b)
// ---------------------------------------------------------------------------
// Warp 0 reads the S partials' (m, l) of the row, 32 at a time, and keeps
// the non-empty ones (l > 0) as a list of (split, weight exp(m_s - m_max))
// in shared memory; then every thread sums its columns over that list with
// independent loads. An empty split's acc is never read (never written).
template <typename T>
__global__ void __launch_bounds__(128) paged_attention_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, const int* __restrict__ tables,
    const int* __restrict__ lens, T* __restrict__ out,
    unsigned char* __restrict__ touched, int KV, int REP, int D, int BT,
    int MB, int S) {
  extern __shared__ float cs[];  // m [S], then (split, weight) [S] each
  float* ms = cs;
  int* live = reinterpret_cast<int*>(cs + S);
  float* wt = cs + 2 * S;
  __shared__ float total_l;
  __shared__ int n_live;
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  if (h == 0 && r == 0) {
    const int len = lens[b];
    const int* row = tables + (long long)b * MB;
    for (int j = tid; j < MB; j += blockDim.x)
      touched[(long long)b * MB + j] = (j * BT < len) && (row[j] >= 0) ? 1 : 0;
  }
  const long long pr0 = part_row(b, h, 0, r, KV, S, REP);  // split stride REP
  if (tid < 32) {
    float mm = NEG_INF;
    for (int s = lane; s < S; s += 32) {
      const float l = part_l[pr0 + (long long)s * REP];
      const float m = l > 0.f ? part_m[pr0 + (long long)s * REP] : NEG_INF;
      ms[s] = m;
      mm = fmaxf(mm, m);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
    float l_sum = 0.f;
    int n = 0;
    for (int base = 0; base < S; base += 32) {
      const int s = base + lane;
      const float l = s < S ? part_l[pr0 + (long long)s * REP] : 0.f;
      const unsigned keep = __ballot_sync(0xffffffffu, l > 0.f);
      if (l > 0.f) {
        const float w = expf(ms[s] - mm);
        const int at = n + __popc(keep & ((1u << lane) - 1u));
        live[at] = s;
        wt[at] = w;
        l_sum += w * l;
      }
      n += __popc(keep);
    }
    l_sum = warp_sum(l_sum);
    if (lane == 0) {
      total_l = l_sum;
      n_live = n;
    }
  }
  __syncthreads();
  const int n = n_live;
  const float inv = 1.f / fmaxf(total_l, 1e-30f);
  const float* acc = part_acc + pr0 * D;
  T* o = out + (((long long)b * KV + h) * REP + r) * D;
  for (int d = tid; d < D; d += blockDim.x) {
    float sum = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i)
      sum += wt[i] * acc[(long long)live[i] * REP * D + d];
    o[d] = from_f<T>(sum * inv);
  }
}

// Raises a kernel's dynamic shared-memory cap to `bytes` once (above the
// default 48 KB); no stream work, so it is safe while a graph is captured.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& done) {
  if (bytes <= 48 * 1024 || bytes <= done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done = bytes;
  return e;
}

template <int DMAX, int MT>
cudaError_t launch_mma(dim3 grid, int nw, size_t smem, cudaStream_t st,
                       const void* q, const void* k, const void* v,
                       const int* tables, const int* lens, float* pm, float* pl,
                       float* pacc, int KV, int REP, int RG, int D, int BT,
                       int MB, int PPS, int n_slots, long long slot_stride,
                       float scale) {
  static size_t done = 0;
  auto kernel = paged_attention_split_mma_kernel<DMAX, MT>;
  const cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 32 * nw, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      tables, lens, pm, pl, pacc, KV, REP, RG, D, BT, MB, PPS, n_slots,
      slot_stride, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(dim3 grid, size_t smem, cudaStream_t st,
                       const void* q, const void* k, const void* v,
                       const int* tables, const int* lens, float* pm, float* pl,
                       float* pacc, int KV, int REP, int RG, int D, int BT,
                       int MB, int PPS, int n_slots, long long slot_stride,
                       float scale) {
  static size_t done = 0;
  auto kernel = paged_attention_split_fma_kernel<T>;
  const cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 32 * RG, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, tables, lens, pm, pl, pacc, KV,
      REP, RG, D, BT, MB, PPS, n_slots, slot_stride, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. tensor_cores: 1 = the mma split kernel
// (bf16, D % 16 == 0, D <= 256, RG <= 32 and RG <= 16 when D > 128; q, k
// and v bases and the slot stride 16-byte aligned), 0 = the CUDA-core one
// (RG <= 32). Each KV head's REP >= 1 query heads go to G = ceil(REP / RG)
// blocks of at most RG heads (ops._paged_groups). The caller passes
// B, KV > 0, n_splits * pps >= MB, and part_m / part_l [B, KV, n_splits,
// REP] and part_acc [B, KV, n_splits, REP, D] fp32 scratch. Launches the
// split kernel, then the combine kernel, on `stream`; returns the first
// launch error (cudaGetLastError after each).
int paged_attention(const void* q, const void* k, const void* v,
                    const int* tables, const int* lens, void* out,
                    unsigned char* touched, float* part_m, float* part_l,
                    float* part_acc, int B, int KV, int REP, int RG, int D,
                    int BT, int MB, int n_slots, long long slot_stride,
                    float scale, int dtype, int tensor_cores, int n_splits,
                    int pps, int n_warps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (REP < 1 || RG < 1 || RG > 32 || RG > REP || D > MAX_D)
    return (int)cudaErrorInvalidValue;
  const long long groups = (long long)KV * ((REP + RG - 1) / RG);
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_splits, (unsigned)groups, B);
  const size_t smem = split_smem_bytes(tensor_cores, RG, D, BT, n_warps);
  cudaError_t e;
  if (tensor_cores) {
    if (dtype != 1 || D % 16 != 0 || (RG > 16 && D > 128) || n_warps < 1 ||
        n_warps > MMA_WARPS_MAX)
      return (int)cudaErrorInvalidValue;
#define PA_MMA(DM, MT)                                                       \
  launch_mma<DM, MT>(grid, n_warps, smem, st, q, k, v, tables, lens, part_m, \
                     part_l, part_acc, KV, REP, RG, D, BT, MB, pps, n_slots, \
                     slot_stride, scale)
    if (RG > 16)
      e = D <= 64 ? PA_MMA(64, 2) : PA_MMA(128, 2);
    else
      e = D <= 64 ? PA_MMA(64, 1) : D <= 128 ? PA_MMA(128, 1) : PA_MMA(256, 1);
#undef PA_MMA
  } else if (dtype == 1) {
    e = launch_fma<__nv_bfloat16>(grid, smem, st, q, k, v, tables, lens,
                                  part_m, part_l, part_acc, KV, REP, RG, D, BT,
                                  MB, pps, n_slots, slot_stride, scale);
  } else {
    e = launch_fma<float>(grid, smem, st, q, k, v, tables, lens, part_m,
                          part_l, part_acc, KV, REP, RG, D, BT, MB, pps,
                          n_slots, slot_stride, scale);
  }
  if (e != cudaSuccess) return (int)e;
  const dim3 cgrid(REP, KV, B);
  const size_t csmem = 3 * sizeof(float) * (size_t)n_splits;
  if (dtype == 1)
    paged_attention_combine_kernel<__nv_bfloat16><<<cgrid, 128, csmem, st>>>(
        part_m, part_l, part_acc, tables, lens, (__nv_bfloat16*)out, touched,
        KV, REP, D, BT, MB, n_splits);
  else
    paged_attention_combine_kernel<float><<<cgrid, 128, csmem, st>>>(
        part_m, part_l, part_acc, tables, lens, (float*)out, touched, KV, REP,
        D, BT, MB, n_splits);
  return (int)cudaGetLastError();
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
