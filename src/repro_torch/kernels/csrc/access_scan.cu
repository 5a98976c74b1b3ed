// access_scan — the Object Collector's sweep over the object table.
//
// Replaces the Pallas TPU kernel `access_scan_pallas` / `_kernel` in
// src/repro/kernels/access_scan.py. Same function, word by word over the
// packed 32-bit table words [ ciw:5 | atc:4 | access:1 | heap:2 | slot:20 ]:
// CIW -> 0 for accessed words, +1 (saturating at 31) for idle ones, 0 for
// dead ones; the Fig. 5 masks to_hot / to_cold with the ATC veto; the
// count of ATC-vetoed objects; and, with_hist, the per-superblock count of
// accessed objects by their current slot.
//
// What bounds it on an H100: bytes. Per word it reads 4 bytes and writes
// 4 + 1 + 1, with a few integer operations in between: 10.5 MB, 3.1 us at
// 3.35 TB/s, for the 2^20 words of a 16 GiB pool of 16 KiB objects. At the
// serve shape (7168 words) the bytes take 21 ns, so what a call costs there
// is one launch and its chain of dependent steps.
//
// Design: ONE launch a call, no memset, every output written by the kernel,
// so a call is one node of a CUDA graph.
//  * A grid-stride pass, four words per thread per step: a 16-byte load and
//    a 16-byte store of the words, and one 4-byte store each of the four
//    to_hot and four to_cold bytes. A scalar pass takes the n % 4 tail, and
//    every word when a base is not aligned for the vector access. (Four
//    such loads in flight a thread cost the 7168-word call 1 us and gained
//    the 2^20-word one 0.3 us; a deeper copy of the bins raised the
//    registers past 90 and cost the 2^20-word call 3 us.)
//  * Partial results cross blocks through a small scratch [ticket and
//    count as one u64 | 2 pad words | n_sbs bins] int32 (the bins 16-byte
//    aligned for the copy out) that the wrapper allocates zeroed
//    once per (device, stream, n_sbs) and keeps. `skipped` is reduced per
//    warp (__reduce_add_sync) and per block in shared memory; the block's
//    thread 0 then adds (1 << 32) | count to the u64 with ONE atomicAdd,
//    which adds its count and takes its ticket at once, so no fence is
//    needed for it. The block that takes the last ticket writes `skipped`
//    and zeroes the u64 (a threadFenceReduction without the fence). The
//    histogram counts in shared-memory bins per block, flushed by one
//    atomicAdd per non-zero bin into the scratch's bins (bins that do not
//    fit in 48 KB go there directly by global atomics; the TPU kernel's
//    one-hot matrix contraction existed only because a TPU has no
//    scatter-add); thread 0 fences before its ticket, and the last block
//    copies the bins to `hist` and zeroes them, 16 bytes a load. So every
//    call, and every replay of a captured call, finds its scratch zero, and
//    two streams never share one. Without the histogram, the blocks write
//    hist's zeros grid-stride.
//  * Integer atomics only: every output is exact and independent of the
//    order in which the blocks run.
//
// The kernel this replaced (one word per thread, `hist` and `skipped`
// zeroed by two cudaMemsetAsync before it, the memset of `hist` made even
// without the histogram) took 0.0036 ms of device time a call at 7168
// words, 672 superblocks (chip_smoke, NVIDIA H100 80GB HBM3, 700.00 W).
#include <stdint.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned SLOT_MASK = (1u << 20) - 1;
constexpr int HEAP_SHIFT = 20, ACCESS_SHIFT = 22, ATC_SHIFT = 23, CIW_SHIFT = 27;
constexpr unsigned HEAP_MASK = 3, ATC_MASK = 15, CIW_MASK = 31, CIW_SAT = 31;
constexpr unsigned NEW = 0, HOT = 1, COLD = 2, FREE = 3;
constexpr int THREADS = 256;
constexpr int U = 4;  // 16-byte loads in flight a thread in the bins' copy
constexpr int SMEM_HIST_MAX = 48 * 1024;

struct Sweep {
  unsigned ct;
  int sb_slots, n_sbs, with_hist;
  int* bins;  // shared-memory bins, or the scratch's when they do not fit
  int skipped = 0;

  // One word: its new word, and its to_hot / to_cold bytes in `hot` /
  // `cold` at bit offset `shift`.
  __device__ __forceinline__ unsigned word(unsigned w, unsigned& hot,
                                           unsigned& cold, int shift) {
    const unsigned heap = (w >> HEAP_SHIFT) & HEAP_MASK;
    const bool live = heap != FREE;
    const bool acc = live && ((w >> ACCESS_SHIFT) & 1u);
    const unsigned atc = (w >> ATC_SHIFT) & ATC_MASK;
    unsigned ciw = (w >> CIW_SHIFT) & CIW_MASK;
    ciw = acc ? 0u : min(ciw + 1u, CIW_SAT);
    if (!live) ciw = 0u;
    const bool movable = live && atc == 0;
    hot |= (unsigned)(acc && (heap == NEW || heap == COLD) && movable) << shift;
    cold |= (unsigned)(!acc && ciw > ct && (heap == NEW || heap == HOT) &&
                       movable) << shift;
    skipped += live && atc > 0 && (acc || (ciw > ct && heap != COLD));
    if (with_hist && acc) {
      const unsigned sb = (w & SLOT_MASK) / (unsigned)sb_slots;
      if (sb < (unsigned)n_sbs) atomicAdd(&bins[sb], 1);
    }
    return (w & ~(CIW_MASK << CIW_SHIFT)) | (ciw << CIW_SHIFT);
  }
};

// scratch: [ticket:32 | count:32 as one u64 | 2 pad words | n_sbs bins],
// zero between calls; the bins start 16 bytes in.
__global__ void __launch_bounds__(THREADS) access_scan_kernel(
    const unsigned* __restrict__ table, const float* __restrict__ ct_ptr,
    unsigned* __restrict__ new_table, unsigned char* __restrict__ to_hot,
    unsigned char* __restrict__ to_cold, int* __restrict__ hist,
    int* __restrict__ skipped, int* __restrict__ scratch, int n, int n4,
    int sb_slots, int n_sbs, int with_hist, int smem_hist) {
  extern __shared__ int smem_bins[];
  __shared__ int block_skipped;
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int gtid = blockIdx.x * THREADS + tid, stride = gridDim.x * THREADS;
  unsigned long long* ticket = reinterpret_cast<unsigned long long*>(scratch);
  int* bins = scratch + 4;
  // hist and the bins as 16-byte pieces when hist is aligned for them
  const int nv = ((uintptr_t)hist & 15) == 0 ? n_sbs / 4 : 0;
  const int4 zero4 = make_int4(0, 0, 0, 0);
  if (tid == 0) block_skipped = 0;
  if (smem_hist)
    for (int i = tid; i < n_sbs; i += THREADS) smem_bins[i] = 0;
  if (!with_hist) {  // hist is all zeros: the grid writes them
    for (int i = gtid; i < nv; i += stride) reinterpret_cast<int4*>(hist)[i] = zero4;
    for (int i = 4 * nv + gtid; i < n_sbs; i += stride) hist[i] = 0;
  }
  __syncthreads();

  const float ctf = floorf(*ct_ptr);
  Sweep sw{ctf <= 0.f ? 0u : (unsigned)ctf, sb_slots, n_sbs, with_hist,
           smem_hist ? smem_bins : bins};
  const uint4* t4 = reinterpret_cast<const uint4*>(table);
  uint4* o4 = reinterpret_cast<uint4*>(new_table);
  unsigned* h4 = reinterpret_cast<unsigned*>(to_hot);
  unsigned* c4 = reinterpret_cast<unsigned*>(to_cold);
  for (int i = gtid; i < n4; i += stride) {
    const uint4 w = t4[i];
    unsigned hot = 0, cold = 0;  // byte j of each is word j's mask
    uint4 o;
    o.x = sw.word(w.x, hot, cold, 0);
    o.y = sw.word(w.y, hot, cold, 8);
    o.z = sw.word(w.z, hot, cold, 16);
    o.w = sw.word(w.w, hot, cold, 24);
    o4[i] = o;
    h4[i] = hot;
    c4[i] = cold;
  }
  for (int i = 4 * n4 + gtid; i < n; i += stride) {
    unsigned hot = 0, cold = 0;
    new_table[i] = sw.word(table[i], hot, cold, 0);
    to_hot[i] = (unsigned char)hot;
    to_cold[i] = (unsigned char)cold;
  }

  const unsigned warp_sum = __reduce_add_sync(0xffffffffu, (unsigned)sw.skipped);
  if ((tid & 31) == 0 && warp_sum) atomicAdd(&block_skipped, (int)warp_sum);
  __syncthreads();
  if (smem_hist) {
    for (int i = tid; i < n_sbs; i += THREADS)
      if (smem_bins[i]) atomicAdd(&bins[i], smem_bins[i]);
    __syncthreads();
  }
  // One atomic adds the block's count and takes its ticket, so the count
  // needs no fence. With the histogram, thread 0's fence (cumulative over
  // the block's bin atomics, which the barrier ordered before it) makes
  // them visible before the ticket, and the last block's fence after it.
  if (tid == 0) {
    if (with_hist) __threadfence();
    const unsigned long long old =
        atomicAdd(ticket, (1ull << 32) | (unsigned)block_skipped);
    last = (unsigned)(old >> 32) == gridDim.x - 1;
    if (last) {
      *skipped = (int)(unsigned)old + block_skipped;
      *ticket = 0ull;
      if (with_hist) __threadfence();
    }
  }
  __syncthreads();
  if (!last || !with_hist) return;
  // the last block copies the bins out (past L1: the atomics landed in L2)
  // and zeroes them, U 16-byte loads in flight a thread
  int4* b4 = reinterpret_cast<int4*>(bins);
  int4* o4h = reinterpret_cast<int4*>(hist);
  for (int base = tid; base < nv; base += U * THREADS) {
    int4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * THREADS < nv) v[u] = __ldcg(b4 + base + u * THREADS);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * THREADS < nv) {
        o4h[base + u * THREADS] = v[u];
        b4[base + u * THREADS] = zero4;
      }
  }
  for (int i = 4 * nv + tid; i < n_sbs; i += THREADS) {
    hist[i] = __ldcg(bins + i);
    bins[i] = 0;
  }
}

}  // namespace

extern "C" {

// One launch on `stream`, no memset; the caller passes n > 0 and `scratch`
// [n_sbs + 4] int32, 16-byte aligned, zero, used by no other stream (the
// kernel leaves it zero). Returns cudaGetLastError().
int access_scan(const void* table, const float* ct, void* new_table,
                unsigned char* to_hot, unsigned char* to_cold, int* hist,
                int* skipped, int* scratch, int n, int sb_slots, int n_sbs,
                int with_hist, int n_sms, void* stream) {
  const size_t hist_bytes = sizeof(int) * (size_t)n_sbs;
  const int smem_hist = with_hist && hist_bytes <= SMEM_HIST_MAX;
  // the vector pass needs 16-byte words and 4-byte mask bases
  const bool vec = (((uintptr_t)table | (uintptr_t)new_table) & 15) == 0 &&
                   (((uintptr_t)to_hot | (uintptr_t)to_cold) & 3) == 0;
  const int n4 = vec ? n / 4 : 0;
  const int items = n4 + (n - 4 * n4);
  int blocks = (items + THREADS - 1) / THREADS;
  if (blocks > 8 * n_sms) blocks = 8 * n_sms;
  access_scan_kernel<<<blocks, THREADS, smem_hist ? hist_bytes : 0,
                       (cudaStream_t)stream>>>(
      (const unsigned*)table, ct, (unsigned*)new_table, to_hot, to_cold, hist,
      skipped, scratch, n, n4, sb_slots, n_sbs, with_hist, smem_hist);
  return (int)cudaGetLastError();
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
