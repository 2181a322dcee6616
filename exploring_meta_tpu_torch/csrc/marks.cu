// Device marks of the port's spans (utils/profiling.py:tracing), sm_90a.
//
// Replaces no TPU kernel. A host span cannot see inside a CUDA-graph
// replay, which launches the graph's kernels without running the Python
// that opened the span; a mark launched on the span's stream at its begin
// and end can, since under capture it becomes a node of the graph and each
// replay stamps it again.
//
// span_mark_kernel is one thread. It reads the device's global nanosecond
// clock (%globaltimer) and appends (tag, time) to a buffer of `capacity`
// stamps, at a slot taken by atomicAdd on the head, so that replays
// launched back to back with no host sync between them all land in it, in
// the order the device ran them. A stamp past the capacity is not written;
// it is counted in counters[1]. The tag is the span's site id times 2,
// plus 1 at the span's end; the buffer, capacity and tag are the launch's
// arguments, fixed at capture.
//
// What bounds it: the launch, a few microseconds of a stream's time; the
// stamp itself is 16 bytes.

#include <cuda_runtime.h>

namespace {

__global__ void span_mark_kernel(unsigned long long* stamps,
                                 unsigned long long* counters,
                                 unsigned long long capacity,
                                 unsigned long long tag) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long slot = atomicAdd(&counters[0], 1ULL);
  if (slot < capacity) {
    stamps[2 * slot] = tag;
    stamps[2 * slot + 1] = now;
  } else {
    atomicAdd(&counters[1], 1ULL);
  }
}

}  // namespace

// counters: [head, dropped]; stamps: [capacity, 2]; -> the launch's
// cudaError_t (0 when queued).
extern "C" int span_mark(void* stamps, void* counters,
                         unsigned long long capacity,
                         unsigned long long tag, void* stream) {
  span_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(stamps),
      static_cast<unsigned long long*>(counters), capacity, tag);
  return static_cast<int>(cudaGetLastError());
}
