// An empty kernel: what a launch of a given grid, block and dynamic shared
// memory costs on the card with no work in it (the launch floor that
// chip_smoke.py's phase 2i prints beside each small decode kernel's time,
// from a CUDA graph of such launches).  A plain C interface for ctypes:
//
//   nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a \
//        -Xcompiler -fPIC -shared -o liblaunch_floor.so launch_floor.cu

#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int launch_floor_empty(int grid, int block, int smem, void* stream) {
  empty_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
