// stamp — one device clock reading written into a window program's stamp
// area, for the span recorder (`repro_torch/spans.py`).
//
// Replaces no TPU kernel: the JAX package's window programs carry no clock.
// It exists so that a CUDA graph replay, which the host cannot see into,
// says where its time goes: each stamp is one node of the captured graph,
// and the span between two stamps is the device time of the work between
// them (a stream runs its kernels one after another).
//
// What bounds it on an H100: launch latency. One thread reads %globaltimer
// (nanoseconds, the device's wall clock) and writes 8 bytes.
//
// Layout of the area, float64 [n]: slot 0 holds the first stamp's absolute
// reading as its 64 raw bits; slot k > 0 holds reading k minus reading 0 as
// a float64 (exact for offsets below 2^53 ns), so that the area rides in
// the window's one float64 device-to-host copy without losing nanoseconds.

#include <cuda_runtime.h>

__global__ void span_stamp_kernel(double* area, int k) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  unsigned long long* raw = reinterpret_cast<unsigned long long*>(area);
  if (k == 0) {
    raw[0] = t;
  } else {
    area[k] = (double)(long long)(t - raw[0]);
  }
}

extern "C" {

// One launch of one thread on `stream`; the caller passes k >= 0 and an
// area whose slot 0 an earlier launch on the same stream wrote (for
// k > 0). Returns cudaGetLastError().
int stamp(void* area, int k, void* stream) {
  span_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((double*)area, k);
  return (int)cudaGetLastError();
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
