// The error string of a CUDA error code, for the Python wrappers' messages,
// and an empty kernel: the floor under any launch (timed by chip_smoke.py).
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int repro_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
