// CUDA streams of a chosen priority, for the port's multiplexing
// (repro_torch._device.priority_stream).  No kernel: PyTorch's
// torch.cuda.Stream draws from a fixed pool of 32 streams per priority in
// turn, so its 33rd stream is its first again; a stream made here is a
// stream of its own.  Non-blocking, as PyTorch's are: it does not wait on
// the legacy default stream.

#include <cuda_runtime.h>

// Makes a stream on `device` with `priority` (clamped by the runtime to
// the device's range) into *out.  The calling thread's current device is
// the same afterwards.  Returns the cudaError_t.
extern "C" int stream_create(int device, int priority, void** out) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  cudaStream_t s = nullptr;
  if (e == cudaSuccess) e = cudaStreamCreateWithPriority(&s, cudaStreamNonBlocking, priority);
  if (e == cudaSuccess) *out = s;
  cudaError_t r = cudaSetDevice(prev);
  return static_cast<int>(e != cudaSuccess ? e : r);
}
