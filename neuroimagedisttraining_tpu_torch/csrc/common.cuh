// Shared by the port's CUDA sources: the C export marker and the error
// string the Python wrappers print when a launch is refused.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NIDT_EXPORT extern "C" __attribute__((visibility("default")))

NIDT_EXPORT const char* nidt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
