// Round marks for the engine's round tracer (batched/roundtrace.py).
//
// round_mark: one thread reads the device's global nanosecond timer
// (%globaltimer) and writes it into a ring of marks, [slots, marks]
// int64, at the row of the round that a device-side counter names
// (counter % slots) and the column `mark`. With `advance` the same
// thread then moves the counter to the next round. The counter lives on
// the device, so a replayed CUDA graph of the round finds its own row
// with no host sync. The tracer's clock calibration uses the same
// kernel on a one-column ring of stamps.
//
// A plain C interface, bound with ctypes; the launch function returns
// the cudaError_t of its launch. The kernel neither allocates nor syncs,
// so a CUDA graph can capture it.

#include <cuda_runtime.h>

__device__ __forceinline__ long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void round_mark(long long* ring, long long* counter, int slots,
                           int marks, int mark, int advance) {
  const long long round = *counter;
  ring[(round % slots) * marks + mark] = global_timer();
  if (advance) *counter = round + 1;
}

extern "C" int round_mark_launch(void* ring, void* counter, int slots,
                                 int marks, int mark, int advance,
                                 void* stream) {
  round_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(counter), slots,
      marks, mark, advance);
  return static_cast<int>(cudaGetLastError());
}
