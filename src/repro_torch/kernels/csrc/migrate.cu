// migrate — the Object Collector's payload mover: data[dst[i]] = data[src[i]]
// for every move with ok[i], in place over the pool's [n_rows, W] data.
//
// Replaces the Pallas TPU kernel `migrate_pallas` / `_kernel` in
// src/repro/kernels/migrate.py. That kernel relies on a SEQUENTIAL grid:
// its moves run in order and each reads its source before any later move
// writes. The collector depends on it, because a cold mover may claim a
// slot that a hot mover of the same pass just vacated (a cold destination
// can be a hot source). Blocks on a GPU run in no order, so moves done in
// parallel in place would race on those slots.
//
// Design: two launches on the caller's stream. The first gathers every
// active move's source row into a staging buffer the wrapper allocates
// ([n_moves, W], at most 2 * move_budget rows); the second scatters the
// staged rows to their destinations. Every source is therefore read
// before any destination is written — the semantics of the TPU kernel and
// of the collector's jnp path. Rows are copied with 16-byte vector loads
// and stores when the row size allows (4-byte or 1-byte otherwise), one
// thread block per (move, chunk of the row). Masked moves (ok = 0) are
// skipped outright, so the pool's scratch row (its last row) is never
// written and stays all-zero. Sources clamp into range (XLA gathers
// clamp); destinations out of range are dropped.
//
// What bounds it on an H100: bytes. An active move reads a row and writes
// it twice over (source -> staging -> destination): 4 * row_bytes of
// traffic against the 2 * row_bytes the move itself needs, the price of
// ordering without a sequential grid. The staging rows stay in the 50 MB
// L2 at the collector's budget (512 rows x 16 KiB = 8 MiB on the
// chatglm3-6b path), so most of the second pass's reads hit the cache.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename V>
__global__ void gather_rows(const char* __restrict__ data, char* __restrict__ staging,
                            const int* __restrict__ src,
                            const unsigned char* __restrict__ ok, int n_rows,
                            long long row_bytes) {
  const int i = blockIdx.x;
  if (!ok[i]) return;
  const int s = min(max(src[i], 0), n_rows - 1);
  const V* from = (const V*)(data + (long long)s * row_bytes);
  V* to = (V*)(staging + (long long)i * row_bytes);
  const long long units = row_bytes / (long long)sizeof(V);
  for (long long u = blockIdx.y * (long long)blockDim.x + threadIdx.x; u < units;
       u += (long long)gridDim.y * blockDim.x)
    to[u] = from[u];
}

template <typename V>
__global__ void scatter_rows(char* __restrict__ data, const char* __restrict__ staging,
                             const int* __restrict__ dst,
                             const unsigned char* __restrict__ ok, int n_rows,
                             long long row_bytes) {
  const int i = blockIdx.x;
  const int d = dst[i];
  if (!ok[i] || d < 0 || d >= n_rows) return;
  const V* from = (const V*)(staging + (long long)i * row_bytes);
  V* to = (V*)(data + (long long)d * row_bytes);
  const long long units = row_bytes / (long long)sizeof(V);
  for (long long u = blockIdx.y * (long long)blockDim.x + threadIdx.x; u < units;
       u += (long long)gridDim.y * blockDim.x)
    to[u] = from[u];
}

template <typename V>
void launch(char* data, char* staging, const int* src, const int* dst,
            const unsigned char* ok, int n_moves, int n_rows,
            long long row_bytes, cudaStream_t s) {
  const long long units = row_bytes / (long long)sizeof(V);
  long long chunks = (units + THREADS - 1) / THREADS;
  if (chunks > 64) chunks = 64;
  if (chunks < 1) chunks = 1;
  const dim3 grid(n_moves, (unsigned)chunks);
  gather_rows<V><<<grid, THREADS, 0, s>>>(data, staging, src, ok, n_rows, row_bytes);
  scatter_rows<V><<<grid, THREADS, 0, s>>>(data, staging, dst, ok, n_rows, row_bytes);
}

}  // namespace

extern "C" {

// Launches on every call; the caller passes n_moves, n_rows and
// row_bytes > 0. Returns cudaGetLastError() after both launches.
int migrate(void* data, void* staging, const int* src, const int* dst,
            const unsigned char* ok, int n_moves, int n_rows,
            long long row_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  char* d = (char*)data;
  char* st = (char*)staging;
  const uintptr_t align = (uintptr_t)d | (uintptr_t)st;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    launch<uint4>(d, st, src, dst, ok, n_moves, n_rows, row_bytes, s);
  else if (row_bytes % 4 == 0 && align % 4 == 0)
    launch<unsigned>(d, st, src, dst, ok, n_moves, n_rows, row_bytes, s);
  else
    launch<unsigned char>(d, st, src, dst, ok, n_moves, n_rows, row_bytes, s);
  return (int)cudaGetLastError();
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
