// Per-device host state of a kernel library (Hopper, sm_90a).
//
// A function attribute set with cudaFuncSetAttribute (the opt-in dynamic
// shared memory) applies to the current device only, and an occupancy
// query answers for the current device. So such state is kept in one slot
// per device ordinal, filled at the first launch on that device; the
// caller makes the tensors' device current first
// (`kernels/_build.py::launch`). A slot holds the value + 1, so 0 means
// "not yet": two threads that fill a slot at once make the same idempotent
// call and store the same value.
//
// Internal linkage, like sort_levels.cuh: each library keeps its own
// slots.

#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;

// The value of `fill()` (an int >= 0: a count, or a CUDA error code) on
// the current device, computed once per device into `slots`; a device
// without a slot asks `fill` at every call.
template <class Fill>
int per_device(std::atomic<int> (&slots)[kMaxDevices], Fill fill) {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return fill();
  int v = slots[dev].load(std::memory_order_acquire);
  if (v == 0) {
    v = fill() + 1;
    slots[dev].store(v, std::memory_order_release);
  }
  return v - 1;
}

}  // namespace
