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
// 4 + 1 + 1, with a few integer operations in between.
//
// Design: a grid-stride elementwise pass, one word per thread per step.
// `skipped` is reduced per warp with shuffles, then per block through
// shared memory, then added to the result with ONE atomicAdd per block.
// The histogram uses shared-memory integer atomics per block, flushed to
// the global bins once per block (global atomics when the bins do not fit
// in 48 KB); the TPU kernel's one-hot matrix contraction existed only
// because a TPU has no scatter-add. Integer atomics keep every output
// exact and independent of the order the blocks run in.
#include <cuda_runtime.h>

namespace {

constexpr unsigned SLOT_MASK = (1u << 20) - 1;
constexpr int HEAP_SHIFT = 20, ACCESS_SHIFT = 22, ATC_SHIFT = 23, CIW_SHIFT = 27;
constexpr unsigned HEAP_MASK = 3, ATC_MASK = 15, CIW_MASK = 31, CIW_SAT = 31;
constexpr unsigned NEW = 0, HOT = 1, COLD = 2, FREE = 3;

__global__ void access_scan_kernel(
    const unsigned* __restrict__ table, const float* __restrict__ ct_ptr,
    unsigned* __restrict__ new_table, unsigned char* __restrict__ to_hot,
    unsigned char* __restrict__ to_cold, int* __restrict__ hist,
    int* __restrict__ skipped, int n, int sb_slots, int n_sbs, int with_hist,
    int smem_hist) {
  extern __shared__ int bins[];
  __shared__ int warp_sums[32];
  if (smem_hist)
    for (int i = threadIdx.x; i < n_sbs; i += blockDim.x) bins[i] = 0;
  __syncthreads();

  const float ctf = floorf(*ct_ptr);
  const unsigned ct = ctf <= 0.f ? 0u : (unsigned)ctf;
  int n_skipped = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const unsigned w = table[i];
    const unsigned heap = (w >> HEAP_SHIFT) & HEAP_MASK;
    const bool live = heap != FREE;
    const bool acc = live && ((w >> ACCESS_SHIFT) & 1u);
    const unsigned atc = (w >> ATC_SHIFT) & ATC_MASK;
    unsigned ciw = (w >> CIW_SHIFT) & CIW_MASK;
    ciw = acc ? 0u : min(ciw + 1u, CIW_SAT);
    if (!live) ciw = 0u;
    const bool movable = live && atc == 0;
    to_hot[i] = acc && (heap == NEW || heap == COLD) && movable;
    to_cold[i] = !acc && ciw > ct && (heap == NEW || heap == HOT) && movable;
    new_table[i] = (w & ~(CIW_MASK << CIW_SHIFT)) | (ciw << CIW_SHIFT);
    n_skipped += live && atc > 0 && (acc || (ciw > ct && heap != COLD));
    if (with_hist && acc) {
      const unsigned sb = (w & SLOT_MASK) / (unsigned)sb_slots;
      if (sb < (unsigned)n_sbs) atomicAdd(smem_hist ? &bins[sb] : &hist[sb], 1);
    }
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    n_skipped += __shfl_xor_sync(0xffffffffu, n_skipped, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = n_skipped;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int wi = 0; wi < (int)(blockDim.x >> 5); ++wi) total += warp_sums[wi];
    if (total) atomicAdd(skipped, total);
  }
  if (smem_hist)
    for (int i = threadIdx.x; i < n_sbs; i += blockDim.x)
      if (bins[i]) atomicAdd(&hist[i], bins[i]);
}

constexpr int THREADS = 256;
constexpr int SMEM_HIST_MAX = 48 * 1024;

}  // namespace

extern "C" {

// Zeroes hist and skipped on the stream, then launches the sweep; the
// caller passes n > 0. Returns cudaGetLastError().
int access_scan(const void* table, const float* ct, void* new_table,
                unsigned char* to_hot, unsigned char* to_cold, int* hist,
                int* skipped, int n, int sb_slots, int n_sbs, int with_hist,
                int n_sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(skipped, 0, sizeof(int), s);
  if (n_sbs > 0) cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)n_sbs, s);
  const size_t hist_bytes = sizeof(int) * (size_t)n_sbs;
  const int smem_hist = with_hist && hist_bytes <= SMEM_HIST_MAX;
  int blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 8 * n_sms) blocks = 8 * n_sms;
  access_scan_kernel<<<blocks, THREADS, smem_hist ? hist_bytes : 0, s>>>(
      (const unsigned*)table, ct, (unsigned*)new_table, to_hot, to_cold, hist,
      skipped, n, sb_slots, n_sbs, with_hist, smem_hist);
  return (int)cudaGetLastError();
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
