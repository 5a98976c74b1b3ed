// migrate — the Object Collector's payload mover: data[dst[i]] = data[src[i]]
// for every move with ok[i], in place over the pool's [n_rows, W] data.
//
// Replaces the Pallas TPU kernel `migrate_pallas` / `_kernel` in
// src/repro/kernels/migrate.py. That kernel relies on a SEQUENTIAL grid:
// its moves run in order and each reads its source's value from before the
// kernel. The collector depends on it, because a cold mover may claim a
// slot that a hot mover of the same pass just vacated (a cold destination
// can be a hot source). Blocks on a GPU run in no order, so moves done in
// parallel in place would race on those slots.
//
// Semantics: every source is read before any destination is written.
// Sources clamp into [0, n_rows); destinations out of range are dropped;
// masked moves (ok = 0) do nothing, so the pool's scratch row (its last
// row) is never written by them and stays all-zero.
//
// What bounds it on an H100: bytes. A move needs 2 * row_bytes (read the
// source, write the destination), plus 9 bytes a lane (src, dst, ok). A
// move staged through a buffer costs 4 * row_bytes (source -> staging ->
// destination), which a gather launch and then a scatter launch pay for
// every move. Here a move is staged
// only when it both reads a row another move writes and writes a row
// another move reads: a move on a cycle (a swap, a self-move) or in the
// middle of a chain of three or more. The collector's lists hold none: a
// cold mover may land in a slot a hot mover vacated in the same pass (the
// COLD ring hands out slots `freelist.push` appended), but hot
// destinations come from the HOT ring, which holds no live slot, so its
// chains are at most two long and every move copies straight across.
//
// Design: ONE persistent launch a call, with the cooperative attribute
// (cudaLaunchKernelEx + cudaLaunchAttributeCooperative), so the launch is
// refused, never deadlocked, when the grid cannot be resident at once; the
// attribute is captured into a CUDA graph's kernel node (a gpu test reads
// it back from the graph). The grid is the SM count times the blocks an SM
// holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor; one block of 1024
// threads, so each barrier counts 132 arrivals): static, so the call needs
// no host sync and can be captured. Three phases, split by two grid
// barriers (an arrive counter in the scratch; a call with no live move
// ends after the first):
//   1. each block compacts its tile of lanes (warp ballots, one atomic a
//      block) into a list of live moves {clamped src, dst} (live: ok and
//      dst in range), and marks each live source in is_src[n_rows] and each
//      live destination in is_dst[n_rows] with plain byte stores of 1;
//   2. a live move whose destination no move reads (not in is_src) is
//      EARLY and copies straight across now; one whose destination is read
//      and whose source is written (in is_dst) is STAGED: its source is read
//      into staging row j, its place in the compacted list, now; the rest
//      are LATE. Every (move, 16-byte unit) of every live move is spread
//      evenly over all threads, software-pipelined: a thread looks up the
//      rows of its next two units (list and mark loads, L2 hits) while the
//      row loads of its current two are in flight. Then the late and
//      staged moves are listed for phase 3 (one atomic a block);
//   3. the late moves copy straight across and the staged rows go from
//      staging to their destinations; the marks of every live move are
//      cleared, and the last block out (a ticket) zeroes the counters: the
//      scratch is all zero after every call.
// Why it is safe: phase 2 writes only rows no move reads, so every read in
// phase 2 finds the value from before the call; phase 3 reads late
// sources, which no move writes, and staging. So every source is read
// before its row is written. `ref.migrate_phased` is the plain model.
// Rows are copied as 16-byte vectors when the row size and the pointers
// allow, else 4-byte, else 1-byte. Cross-phase data (the lists, marks,
// counters and staging) is read with ld.global.cg, at L2, never from a
// stale L1 line. It is a copy: bit-exact in any dtype.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 2;   // row loads in flight a thread (see copy_units)

// scratch layout: four counters, then is_src[n_rows], then is_dst[n_rows]
enum { N_LIVE = 0, N_LATE = 1, ARRIVE = 2, TICKET = 3, N_CTL = 4 };

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Grid barrier k of a call: every block arrives once (a release add),
// then waits until the counter holds k * gridDim.x (acquire loads). Safe
// because the launch is cooperative (all blocks resident); the last block
// out of the call resets the counter.
__device__ __forceinline__ void grid_barrier(unsigned* arrive, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" :: "l"(arrive) : "memory");
    while (ld_acquire(arrive) < target) {}
  }
  __syncthreads();
}

// Block-wide stream compaction: returns the slot of this thread's flagged
// item in the list whose length `counter` holds (one atomic a block), or
// -1 when `flag` is false. Every thread of the block must call it.
__device__ __forceinline__ int block_append(bool flag, unsigned* counter) {
  __shared__ unsigned warp_base[WARPS];
  __shared__ unsigned block_base;
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x < 32) {   // one warp scans the warp counts
    const unsigned c = lane < WARPS ? warp_base[lane] : 0u;
    unsigned incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane < WARPS) warp_base[lane] = incl - c;
    if (lane == 31) block_base = incl ? atomicAdd(counter, incl) : 0u;
  }
  __syncthreads();
  const int slot = flag ? (int)(block_base + warp_base[warp] +
                                __popc(ballot & ((1u << lane) - 1u)))
                        : -1;
  __syncthreads();   // warp_base / block_base are reused by the next call
  return slot;
}

// Walks units f = start, start + stride, ... of an [items, upr] space as
// (item, unit) pairs, with no division after the first.
struct Cursor {
  unsigned item, unit, d_item, d_unit, upr;
  __device__ Cursor(unsigned start, unsigned stride, unsigned upr_)
      : item(start / upr_), unit(start % upr_), d_item(stride / upr_),
        d_unit(stride % upr_), upr(upr_) {}
  __device__ __forceinline__ void next() {
    item += d_item;
    unit += d_unit;
    if (unit >= upr) { unit -= upr; ++item; }
  }
};

// A row reference: r >= 0 is data row r, r < 0 staging row -1 - r, SKIP none.
constexpr int SKIP = INT_MIN;

template <typename V>
__device__ __forceinline__ V* unit_ptr(char* data, char* staging, int r,
                                       unsigned unit, long long rb) {
  char* base = r >= 0 ? data + r * rb : staging + (-1ll - r) * rb;
  return (V*)base + unit;
}

// Copies every unit of items [0, n_items) that `rows` maps to a (from, to)
// pair of row references, walking the units from `c` in batches of UNROLL,
// software-pipelined: the next batch's rows (list and mark loads, which
// hit L2) are looked up while this batch's row loads are in flight.
template <typename V, typename Rows>
__device__ __forceinline__ void copy_units(char* data, char* staging, long long rb,
                                           Cursor c, unsigned n_items,
                                           const Rows& rows) {
  int from[UNROLL], to[UNROLL];
  unsigned unit[UNROLL];
  bool more = c.item < n_items;
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    to[k] = SKIP;
    if (c.item < n_items) rows(c.item, from[k], to[k]);
    unit[k] = c.unit;
    c.next();
  }
  while (more) {
    V v[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      if (to[k] != SKIP) v[k] = __ldcg(unit_ptr<V>(data, staging, from[k], unit[k], rb));
    more = c.item < n_items;
    int next_from[UNROLL], next_to[UNROLL];
    unsigned next_unit[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      next_to[k] = SKIP;
      if (c.item < n_items) rows(c.item, next_from[k], next_to[k]);
      next_unit[k] = c.unit;
      c.next();
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (to[k] != SKIP) *unit_ptr<V>(data, staging, to[k], unit[k], rb) = v[k];
      from[k] = next_from[k];
      to[k] = next_to[k];
      unit[k] = next_unit[k];
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(THREADS, 1)
migrate_kernel(char* __restrict__ data, char* __restrict__ staging,
               int2* __restrict__ moves, int2* __restrict__ late,
               unsigned* __restrict__ ctl, unsigned char* __restrict__ is_src,
               unsigned char* __restrict__ is_dst, const int* __restrict__ src,
               const int* __restrict__ dst, const unsigned char* __restrict__ ok,
               int n_moves, int n_rows, long long row_bytes) {
  const unsigned n_threads = gridDim.x * THREADS;
  const unsigned gtid = blockIdx.x * THREADS + threadIdx.x;
  const Cursor start(gtid, n_threads, (unsigned)(row_bytes / (long long)sizeof(V)));

  // phase 1: compact the live lanes, mark their sources and destinations
  for (int base = blockIdx.x * THREADS; base < n_moves; base += n_threads) {
    const int i = base + threadIdx.x;
    bool live = false;
    int s = 0, d = 0;
    if (i < n_moves) {
      const bool o = ok[i];
      d = dst[i];
      s = min(max(src[i], 0), n_rows - 1);
      live = o && d >= 0 && d < n_rows;
    }
    const int slot = block_append(live, &ctl[N_LIVE]);
    if (live) {
      moves[slot] = make_int2(s, d);
      is_src[s] = 1;
      is_dst[d] = 1;
    }
  }
  grid_barrier(&ctl[ARRIVE], gridDim.x);

  const unsigned n_live = __ldcg(&ctl[N_LIVE]);
  int2 mine = make_int2(0, 0);        // this thread's move, to classify
  if (n_live > 0) {
    // phase 2: early moves copy across, staged moves' sources go to
    // staging; then the late and staged moves are listed for phase 3
    if (gtid < n_live) mine = __ldcg(&moves[gtid]);
    copy_units<V>(data, staging, row_bytes, start, n_live,
                  [&](unsigned j, int& from, int& to) {
      const int2 m = __ldcg(&moves[j]);
      const bool read = __ldcg(&is_src[m.y]);     // its destination is read
      const bool written = __ldcg(&is_dst[m.x]);  // its source is written
      from = m.x;
      to = !read ? m.y : written ? -1 - (int)j : SKIP;
    });
    for (unsigned base = blockIdx.x * THREADS; base < n_live; base += n_threads) {
      const unsigned j = base + threadIdx.x;
      int2 m = mine;
      if (base != blockIdx.x * THREADS && j < n_live) m = __ldcg(&moves[j]);
      const bool read = j < n_live && __ldcg(&is_src[m.y]);
      const int slot = block_append(read, &ctl[N_LATE]);
      // a staged move is listed as {its staging row, dst}
      if (read) late[slot] = __ldcg(&is_dst[m.x]) ? make_int2(-1 - (int)j, m.y) : m;
    }
    grid_barrier(&ctl[ARRIVE], 2u * gridDim.x);

    // phase 3: late moves copy across, staged rows go to their
    // destinations; then the marks are cleared
    copy_units<V>(data, staging, row_bytes, start, __ldcg(&ctl[N_LATE]),
                  [&](unsigned k, int& from, int& to) {
      const int2 m = __ldcg(&late[k]);
      from = m.x;
      to = m.y;
    });
    if (gtid < n_live) {
      is_src[mine.x] = 0;
      is_dst[mine.y] = 0;
    }
    for (unsigned j = gtid + n_threads; j < n_live; j += n_threads) {
      const int2 m = __ldcg(&moves[j]);
      is_src[m.x] = 0;
      is_dst[m.y] = 0;
    }
  }
  // every block has read the counters: the last one out zeroes them
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&ctl[TICKET], 1u) == gridDim.x - 1) {
      ctl[N_LIVE] = 0;
      ctl[N_LATE] = 0;
      ctl[ARRIVE] = 0;
      ctl[TICKET] = 0;
    }
  }
}

template <typename V>
cudaError_t launch(char* data, char* staging, int* work, unsigned char* scratch,
                   const int* src, const int* dst, const unsigned char* ok,
                   int n_moves, int n_rows, long long row_bytes, int n_sms,
                   cudaStream_t s) {
  if (row_bytes / (long long)sizeof(V) >= (1ll << 31) || n_moves >= (1 << 30))
    return cudaErrorInvalidValue;
  static int per_sm = 0;   // blocks an SM holds, the same on every H100
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, migrate_kernel<V>, THREADS, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_sms * per_sm));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  unsigned* ctl = (unsigned*)scratch;
  unsigned char* is_src = scratch + N_CTL * sizeof(unsigned);
  return cudaLaunchKernelEx(&cfg, migrate_kernel<V>, data, staging, (int2*)work,
                            (int2*)work + n_moves, ctl, is_src, is_src + n_rows,
                            src, dst, ok, n_moves, n_rows, row_bytes);
}

}  // namespace

extern "C" {

// One cooperative launch on every call; the caller passes n_moves, n_rows
// and row_bytes > 0. staging: [n_moves, row_bytes]; work: 4 * n_moves
// int32 (the compacted moves, then phase 3's list); scratch: 16 + 2 *
// n_rows bytes, all zero, which the kernel leaves zero. Returns the launch's
// error code.
int migrate(void* data, void* staging, void* work, void* scratch,
            const int* src, const int* dst, const unsigned char* ok,
            int n_moves, int n_rows, long long row_bytes, int n_sms,
            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  char* d = (char*)data;
  char* st = (char*)staging;
  int* w = (int*)work;
  unsigned char* sc = (unsigned char*)scratch;
  const uintptr_t align = (uintptr_t)d | (uintptr_t)st;
  cudaError_t e;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    e = launch<uint4>(d, st, w, sc, src, dst, ok, n_moves, n_rows, row_bytes, n_sms, s);
  else if (row_bytes % 4 == 0 && align % 4 == 0)
    e = launch<unsigned>(d, st, w, sc, src, dst, ok, n_moves, n_rows, row_bytes, n_sms, s);
  else
    e = launch<unsigned char>(d, st, w, sc, src, dst, ok, n_moves, n_rows, row_bytes, n_sms, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What a captured CUDA graph holds: counts[0] nodes, counts[1] kernel
// nodes, counts[2] kernel nodes with the cooperative attribute set.
int graph_nodes(void* graph, int* counts) {
  cudaGraph_t g = (cudaGraph_t)graph;
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return (int)e;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n && (e = cudaGraphGetNodes(g, nodes.data(), &n)) != cudaSuccess) return (int)e;
  counts[0] = (int)n;
  counts[1] = counts[2] = 0;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    if ((e = cudaGraphNodeGetType(node, &type)) != cudaSuccess) return (int)e;
    if (type != cudaGraphNodeTypeKernel) continue;
    ++counts[1];
    cudaLaunchAttributeValue v = {};
    if ((e = cudaGraphKernelNodeGetAttribute(node, cudaLaunchAttributeCooperative,
                                             &v)) != cudaSuccess)
      return (int)e;
    counts[2] += v.cooperative != 0;
  }
  return 0;
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
