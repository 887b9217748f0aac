// Per-device launch state. cudaFuncSetAttribute acts on the current
// device, which the Python wrappers set from their inputs before every
// launch (`kernels/build.py` `on_device`), so a launch helper that grants
// a kernel more shared memory keeps one grant a device: a second card must
// get its own grant before it launches.
#pragma once

#include <cuda_runtime.h>

namespace sosdev {

constexpr int kMaxDevices = 64;  // slots of per-device launch state

// The current device, the index of per-device launch state (0 when the
// query fails: the launch that follows reports the error).
inline int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev < kMaxDevices ? dev : 0;
}

}  // namespace sosdev
