// Grid sizing for the persistent kernels (shade.cu, surface.cu, surface_v2.cu,
// traverse.cu, track.cu, lt_splat.cu, and points.cu and curves.cu through
// walk2.cuh): as many blocks as the current device holds at once, so each
// block does its set-up once and then loops over the work.
#pragma once
#include <cuda_runtime.h>

#include <mutex>

// SMs x resident blocks of `threads` threads of `kernel` per SM, queried
// at the first call for a kernel, block size and device and kept (the
// occupancy query costs more host time than a small launch)
static cudaError_t resident_blocks(const void* kernel, int threads, int* out) {
  struct Known {
    const void* kernel;
    int threads, dev, blocks;
  };
  static Known known[64];
  static int n_known = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    const std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n_known; ++i) {
      if (known[i].kernel == kernel && known[i].threads == threads && known[i].dev == dev) {
        *out = known[i].blocks;
        return cudaSuccess;
      }
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  if (sms < 1 || per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  const std::lock_guard<std::mutex> lock(mu);
  if (n_known < 64) known[n_known++] = Known{kernel, threads, dev, *out};
  return cudaSuccess;
}

// the lanes one pass of the resident grid covers, one lane a thread
static cudaError_t resident_lanes(const void* kernel, int threads, int64_t* out) {
  int blocks = 0;
  const cudaError_t err = resident_blocks(kernel, threads, &blocks);
  *out = (int64_t)blocks * threads;
  return err;
}
