// Device guard shared by the port's kernel libraries.

#pragma once

#include <cuda_runtime.h>

// Makes `device` current for the calling thread and restores the previous
// device on scope exit, as PyTorch's device guard does around an op.
struct DeviceGuard {
    int prev = -1;
    cudaError_t status;
    explicit DeviceGuard(int device) {
        status = cudaGetDevice(&prev);
        if (status == cudaSuccess && prev != device) status = cudaSetDevice(device);
    }
    ~DeviceGuard() {
        if (prev >= 0) cudaSetDevice(prev);
    }
};
