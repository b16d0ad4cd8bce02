// Asynchronous global -> shared copies (cp.async, sm_80+) for the z-sweep and the
// fused sum-factorized kernels: a copy starts without holding a register, and a
// block waits for its groups of copies with cp_async_wait<N>() before a barrier.

#pragma once

#include <cuda_runtime.h>

// Copy BYTES (4, 8 or 16) from src to dst; with valid == false the destination is
// filled with zeros and src is not read (it must still be a valid address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const int n = valid ? BYTES : 0;
    if (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
