// flash_attention_wgmma — the bfloat16 flash_attention on Hopper's tensor
// cores: wgmma for both products, K/V tiles brought in by TMA.
//
// Replaces, for bf16 inputs with D <= 128 that a TMA tensor map can describe
// (the rule is `_flash_variant` in kernels/ops.py), the Pallas TPU kernel
// `flash_attention_pallas` / `_kernel` in src/repro/kernels/flash_attention.py.
// Same function as flash_attention.cu, which keeps every other input: for q
// [B,S,H,D] and k/v [B,S,KV,D], out[b,i,h] = sum_j softmax_j(s_ij)
// v[b,j,h/rep] with s_ij = (q[b,i,h] . k[b,j,h/rep]) * D^-0.5, rep = H/KV,
// masked from the absolute positions i, j in [0, S) (causal: j <= i; window
// > 0: j > i - window) with the TPU kernel's finite NEG_INF. The scores, the
// softmax statistics and the accumulator are fp32; the probabilities enter
// P.V rounded to bf16; the output is bf16.
//
// What bounds it on an H100: operations. At the chatglm3-6b prefill shape
// (B=2, S=4096, H=32, KV=2, D=128, causal) a call does ~275 GFLOP on the bf16
// tensor cores (989 TFLOP/s): ~0.28 ms, against ~0.04 ms to move its ~143 MB.
//
// Design (one thread block per (batch, KV head, tile of 128 query rows)):
//  - A query row is a (position, head) pair: a tile covers the HB query heads
//    that share the KV head (HB = the largest divisor of rep up to 64) at P =
//    64 / HB consecutive positions per consumer warpgroup, two warpgroups of
//    64 rows (wgmma's M) each. Every K/V tile serves all of them: no GQA
//    repeat, no transpose in memory. With rep = 3 a warpgroup holds 63 rows.
//  - Shared memory holds bf16 tiles in the 128-byte swizzle that wgmma's
//    descriptors read: Q (two warpgroups x D/64 chunks of 64 rows x 64
//    columns, loaded once) and a two-stage ring of K and V tiles of BK = 128
//    keys. D is zero-padded to DP = 64 or 128 by the loads themselves.
//  - A producer warp (one thread of it) issues every load with TMA
//    (cp.async.bulk.tensor; 4-D maps (D, heads, S, B) built from the
//    tensors' strides, 64-column boxes; rows and columns out of range arrive
//    as zeros), completing on mbarriers, while the consumers compute; the
//    consumers release a stage through an "empty" mbarrier. 288 threads
//    leave 168 registers a thread (three warps share an SM sub-partition's
//    16384), which the consumers fit in without spilling.
//  - S = Q.K^T with wgmma m64n128k16 (both operands K-major in shared
//    memory); the scale, with log2(e) folded in, is applied to the fp32
//    scores. Online softmax in registers on the accumulator fragment: a
//    thread holds 2 rows x 32 keys; row max and sum reduce over the quad.
//    The mask is applied only on tiles that cross the diagonal, the window
//    edge or S; wholly masked tiles are skipped (see flash_attention.cu for
//    why that is exactly the TPU kernel's result). Latest positions first.
//  - O += P.V with wgmma m64n{DP}k16: P goes from the score fragment to bf16
//    A fragments in registers (the accumulator's layout is the A operand's),
//    never through shared memory; V is read MN-major (transposed B).
//  - Epilogue: acc / max(l, 1e-30) in fp32, stored as bf16 to the contiguous
//    [B, S, H, D] output.
//
// The tensor maps are encoded on the host per call by cuTensorMapEncodeTiled,
// reached through the runtime's cudaGetDriverEntryPoint(ByVersion), so the
// library needs no -lcuda; they are passed as __grid_constant__ parameters.
//
// Later work: ping-pong between the two consumer warpgroups (one's softmax
// under the other's wgmma), a persistent grid, D > 128.
#include <cuda.h>  // CUtensorMap and its enums; no driver symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr float NEG_INF = -2.3819763e38f;  // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WG_ROWS = 64;       // query rows per consumer warpgroup
constexpr int BK = 128;           // keys per tile
constexpr int STAGES = 2;         // K/V ring depth
constexpr int CONSUMERS = 256;    // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int CHUNK = 64;         // bf16 columns per 128-byte swizzled row
constexpr int SW_ROWS = 8;        // rows per swizzle atom (1024 bytes)

template <int DP>
struct Smem {
  static constexpr int NC = DP / CHUNK;             // D chunks
  static constexpr int Q_CHUNK = WG_ROWS * 128;     // bytes per Q chunk
  static constexpr int KV_CHUNK = BK * 128;         // bytes per K/V chunk
  static constexpr int Q = 2 * NC * Q_CHUNK;
  static constexpr int K = STAGES * NC * KV_CHUNK;
  static constexpr int BARS = 1 + 3 * STAGES;       // q, full_k, full_v, empty
  // + 1024: the tiles start at the next 1024-byte boundary (swizzle atoms)
  static constexpr size_t BYTES = Q + 2 * K + 8 * BARS + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
// A wait of more than 2^32 cycles (over 2 s) is a fault in the pipeline:
// it traps, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins the accumulator registers at this point of the program, so that no
// read of them moves above the wgmma wait (or a write below the issue).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[64 x 128] (+)= a[64 x 16] . b[128 x 16]^T; a and b K-major in shared
// memory (descriptors). accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 128] += a[64 x 16] . b[16 x 128]; a in registers (four bf16x2 per
// thread), b MN-major in shared memory (descriptor, transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] += a[64 x 16] . b[16 x 64]; a in registers (four bf16x2 per
// thread), b MN-major in shared memory (descriptor, transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ out, int S, int H,
                             int KV, int D, int HB, int P, float scale_log2,
                             int causal, int window) {
  using L = Smem<DP>;
  constexpr int NC = L::NC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + L::Q, sv = sk + L::K, bars = sv + L::K;
  const uint32_t q_full = bars;
  // per stage s: full_k at bars + 8 (1 + s), full_v at + 8 (1 + STAGES + s),
  // empty at + 8 (1 + 2 STAGES + s)

  const int tid = threadIdx.x;
  const int rep = H / KV, groups = rep / HB;
  const int kvh = blockIdx.x / groups;
  const int h0 = kvh * rep + (blockIdx.x % groups) * HB;
  const int b = blockIdx.y;
  const int p0 = (gridDim.z - 1 - blockIdx.z) * 2 * P;  // longest first
  const int last = min(p0 + 2 * P, S) - 1;
  const int j_hi = causal ? last + 1 : S;
  int j_lo = window > 0 ? max(0, p0 - window + 1) : 0;
  j_lo -= j_lo % BK;
  const int n_tiles = (j_hi - j_lo + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + STAGES + s), 1);
      mbar_init(bars + 8 * (1 + 2 * STAGES + s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: one thread issues every load
    if (tid != CONSUMERS) return;
    mbar_expect_tx(q_full, 2 * NC * CHUNK * HB * P * 2);
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < NC; ++c)
        tma_load(sq + (w * NC + c) * L::Q_CHUNK, &tm_q, q_full, c * CHUNK, h0,
                 p0 + w * P, b);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES, j0 = j_lo + t * BK;
      if (t >= STAGES)  // the consumers have released the tile t - STAGES
        mbar_wait(bars + 8 * (1 + 2 * STAGES + s), (t / STAGES - 1) & 1);
      const uint32_t fk = bars + 8 * (1 + s), fv = bars + 8 * (1 + STAGES + s);
      mbar_expect_tx(fk, NC * L::KV_CHUNK);
      for (int c = 0; c < NC; ++c)
        tma_load(sk + (s * NC + c) * L::KV_CHUNK, &tm_k, fk, c * CHUNK, kvh,
                 j0, b);
      mbar_expect_tx(fv, NC * L::KV_CHUNK);
      for (int c = 0; c < NC; ++c)
        tma_load(sv + (s * NC + c) * L::KV_CHUNK, &tm_v, fv, c * CHUNK, kvh,
                 j0, b);
    }
    return;
  }

  // consumers: warpgroup w owns rows 64 w .. 64 w + 63 of the tile; this
  // thread holds rows r0 and r0 + 8 of them, keys (columns) 8 c + 2 (lane % 4)
  // + {0, 1} for c < BK / 8 (wgmma's accumulator fragment)
  const int w = tid / 128, lane = tid % 32;
  const int r0 = (tid % 128) / 32 * 16 + lane / 4;
  const int rows = HB * P;
  int qpos[2];
  bool store[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h, pos = p0 + w * P + r / HB;
    store[h] = r < rows && pos < S;
    qpos[h] = store[h] ? pos : last;  // pad rows: never stored
  }
  const int col0 = 2 * (lane % 4);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint32_t q_tile = sq + w * NC * L::Q_CHUNK;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES, j0 = j_lo + t * BK;
    const uint32_t phase = (t / STAGES) & 1;
    const uint32_t k_tile = sk + s * NC * L::KV_CHUNK;
    const uint32_t v_tile = sv + s * NC * L::KV_CHUNK;

    // S = Q . K^T: DP / 16 steps of 16 columns, 32 bytes into the swizzled row
    float sc[BK / 2];
    mbar_wait(bars + 8 * (1 + s), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss(sc,
               sw128_desc(q_tile + (kk / 4) * L::Q_CHUNK + off, 16,
                          SW_ROWS * 128),
               sw128_desc(k_tile + (kk / 4) * L::KV_CHUNK + off, 16,
                          SW_ROWS * 128),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scores in the log2 domain, masked where the tile crosses an edge
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
    const bool edge = j0 + BK > S || (causal && j0 + BK - 1 > p0) ||
                      (window > 0 && j0 <= last - window);
    if (edge) {
      // row h keeps keys j in (lo, hi]: j < S, j <= i if causal, j > i -
      // window if windowed; key j = j0 + col0 + a constant of the element
      int lo[2], hi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        hi[h] = (causal ? min(qpos[h], S - 1) : S - 1) - j0 - col0;
        lo[h] = (window > 0 ? qpos[h] - window : -1) - j0 - col0;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int c = 8 * (i / 4) + (i % 2), h = (i / 2) % 2;
        if (c <= lo[h] || c > hi[h]) sc[i] = NEG_INF;
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = ex2(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
    uint32_t pa[BK / 4];  // P in bf16: the A fragments of BK / 16 steps
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int h = (i / 2) % 2;
      const float a = ex2(sc[i] - m[h]), c = ex2(sc[i + 1] - m[h]);
      l[h] += a + c;
      pa[i / 2] = pack_bf16(a, c);
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i / 2) % 2];

    // O += P . V: BK / 16 steps of 16 keys (2048 bytes of the V tile each);
    // the second 64 columns of V lie one chunk (BK * 128 bytes) further
    mbar_wait(bars + 8 * (1 + STAGES + s), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(o, pa + 4 * kk,
               sw128_desc(v_tile + kk * 16 * 128, L::KV_CHUNK, SW_ROWS * 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (1 + 2 * STAGES + s));
  }

  // epilogue: the quad's partial sums, then acc / max(l, 1e-30) in bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!store[h]) continue;
    const int r = r0 + 8 * h;
    const float den = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow =
        out + (((long long)b * S + qpos[h]) * H + h0 + r % HB) * D;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int d = 8 * c + col0;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            o[4 * c + 2 * h] / den, o[4 * c + 2 * h + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launch
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Error codes of this library beyond the runtime's (see error_string).
constexpr int ERR_NO_ENCODER = 10000;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 20000;      // + the CUresult of a failed encode

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 map (D, heads, S, B) with the given element strides, boxes of
// 64 columns x box_heads x box_pos x 1, 128-byte swizzle, zeros out of range.
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int D, int heads,
           int S, int B, const long long* st, int box_heads, int box_pos) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  // bytes; the strides of (heads, S, B): st = (batch, position, head)
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {CHUNK, (cuuint32_t)box_heads, (cuuint32_t)box_pos,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int D, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const int rep = H / KV;
  int hb = rep < WG_ROWS ? rep : WG_ROWS;
  while (rep % hb) --hb;  // the largest divisor of rep up to 64
  const int P = WG_ROWS / hb;
  CUtensorMap tq, tk, tv;
  int e = encode(fn, &tq, q, D, H, S, B, st, hb, P);
  if (e == 0) e = encode(fn, &tk, k, D, KV, S, B, st + 3, 1, BK);
  if (e == 0) e = encode(fn, &tv, v, D, KV, S, B, st + 6, 1, BK);
  if (e != 0) return e;
  auto kern = flash_attention_wgmma_kernel<DP>;
  const cudaError_t a = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<DP>::BYTES);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid(KV * (rep / hb), B, (S + 2 * P - 1) / (2 * P));
  kern<<<grid, THREADS, Smem<DP>::BYTES, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, S, H, KV, D, hb, P, scale * LOG2E,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q [B,S,H,D], k/v [B,S,KV,D], each with unit stride along D and
// element strides (batch, position, head) in `strides` (q's three, k's,
// v's); out [B,S,H,D] contiguous bf16. The caller passes B, S, H, KV > 0,
// H % KV == 0, D <= 128 with D % 8 == 0, 16-byte-aligned pointers and
// strides that are positive multiples of 8 (`_flash_variant` in ops.py).
// Returns cudaGetLastError() after the launch, or an error of the tensor
// maps (error_string names it).
int flash_attention_wgmma(const void* q, const void* k, const void* v,
                          void* out, int B, int S, int H, int KV, int D,
                          const long long* strides, float scale, int causal,
                          int window, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 64)
    return launch<64>(q, k, v, out, B, S, H, KV, D, strides, scale, causal,
                      window, s);
  return launch<128>(q, k, v, out, B, S, H, KV, D, strides, scale, causal,
                     window, s);
}

const char* error_string(int e) {
  static char buf[96];
  if (e == ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (e >= ERR_ENCODE) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             e - ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
