// The device of one launch, restored on every return path.
//
// Each launch function of this directory runs on the device of the
// tensors it is given, which need not be the caller's current device: on
// a mesh of cards (hmvec_tpu_torch/parallel/sharding.py) a slot on cuda:1
// launches while the host thread's current device is cuda:0.  A launcher
// that set the device and left it set would move the thread to cuda:1, and
// every later unindexed "cuda" allocation and torch.cuda.current_device()
// with it.  DeviceGuard reads the current device, switches only when the
// launch's device differs, and switches back when it goes out of scope,
// after a refused launch too.

#pragma once

#include <cuda_runtime.h>

namespace hmvec {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&saved_);
    if (err_ == cudaSuccess && saved_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(saved_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaSuccess, or the error of reading or setting the device
  cudaError_t error() const { return err_; }

 private:
  int saved_ = 0;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace hmvec
