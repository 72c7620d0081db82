// Grid sizing for the persistent kernels (shade.cu, traverse.cu): as many
// blocks as the current device holds at once, so each block does its
// set-up once and then loops over the work.
#pragma once
#include <cuda_runtime.h>

// SMs x resident blocks of `threads` threads of `kernel` per SM
static cudaError_t resident_blocks(const void* kernel, int threads, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  if (sms < 1 || per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  return cudaSuccess;
}

// the lanes one pass of the resident grid covers, one lane a thread
static cudaError_t resident_lanes(const void* kernel, int threads, int64_t* out) {
  int blocks = 0;
  const cudaError_t err = resident_blocks(kernel, threads, &blocks);
  *out = (int64_t)blocks * threads;
  return err;
}
