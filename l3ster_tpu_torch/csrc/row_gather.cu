// Node-row gather and scatter-add of the gather-family operator apply, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the element gather and the scatter-add
// of its unstructured apply to XLA.  On the card PyTorch's row gather
// (x.reshape(n_rows, c)[idx], at::native::vectorized_gather_kernel) launches one block
// per index, one thread of which moves a 16-byte row, so it ran block-scheduling bound at
// ~1.5% of its byte bound on the p = 4 cylinder (1.3 ms of a 4.8 ms apply); two transpose
// copies and index_add_ followed it.  These two kernels take their place
// (ops/rows.py:gather_rows, scatter_rows_add).
//
// The operator's vectors hold n_rows node rows of c unknowns; the n local nodes of
// element e read rows idx[e, a] (int32, (E, n)).  Pair k = e * n + a.
//   gather:  out[e, :, a] = x[idx[e, a], :]
//            channel-major out (E, c, n): the first basis SGEMM's (E*c, n) operand
//            (ops/dense_eval.py), so no transpose follows; or node-major (E, n, c).
//            x is any row-strided view: row r at x + r * srow, unknown u at + u * sunk,
//            so a column x[:, r] of a multi-RHS block is read in place.
//   scatter: flat[idx[e, a], :] += y[e, :, a], y read in place in either layout (the
//            second SGEMM's (E*c, n) output, or the node-major y_loc of the other kinds);
//            flat is a contiguous (n_rows, c) accumulator.
//
// What bounds them on this card: bytes, and the latency of the dependent index -> row
// load.  At the cylinder (E = 17,456, n = 125, c = 4, f32) the gather reads 8.7 MB of
// int32 indices and at most the 19 MB of x (resident in the 50 MB L2) and writes 35 MB:
// ~0.02 ms at 3.35 TB/s.  The design:
// - One thread a pair, RG_THREADS pairs a block, thousands of blocks: every SM holds 2,048
//   threads, each with one index load and one row load in flight.
// - Consecutive threads take consecutive pairs, so the index loads, each plane of the
//   channel-major layout (consecutive nodes a of one element) and the node-major rows
//   are all read or written at stride 1.
// - A row is loaded as one VW-wide vector (float4, float2, double2) where the host found
//   the row and its unknowns contiguous and aligned to it (VW == 1: scalar loads, any
//   stride, any base).
// - The scatter adds with atomicAdd: in f32 one float4 (or float2) vector atomic a row on
//   sm_90, in f64 one scalar atomic an unknown.  index_add_ is atomic too, so the order
//   of the sums varies from run to run as it did; each sum stays a sum of the same terms.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (l3ster_tpu_torch/ops/rows.py builds and loads it with ctypes).

#include <cuda_runtime.h>

#include "device_guard.cuh"

constexpr int RG_THREADS = 256;  // pairs (threads) a block

template <typename T, int VW> struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<double, 1> { using type = double; };
template <> struct Vec<double, 2> { using type = double2; };

template <typename T, int VW>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[VW])
{
    const typename Vec<T, VW>::type w = *reinterpret_cast<const typename Vec<T, VW>::type*>(p);
    const T* s = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int j = 0; j < VW; ++j) v[j] = s[j];
}

template <typename T, int VW>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[VW])
{
    typename Vec<T, VW>::type w;
    T* s = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int j = 0; j < VW; ++j) s[j] = v[j];
    *reinterpret_cast<typename Vec<T, VW>::type*>(p) = w;
}

template <typename T, int VW>
__device__ __forceinline__ void atomic_add_vec(T* p, const T (&v)[VW])
{
    if constexpr (VW == 4) {
        atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    } else if constexpr (VW == 2) {
        atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
    } else {
        atomicAdd(p, v[0]);
    }
}

// out[e, :, a] (CM: out + (e * c + u) * n + a; else out + k * c + u) = x[idx[k] * srow + u * sunk].
template <typename T, bool CM, int VW>
__global__ void __launch_bounds__(RG_THREADS)
    rows_gather(const T* __restrict__ x, long long srow, long long sunk, const int* __restrict__ idx,
                T* __restrict__ out, int n_pairs, int n, int c)
{
    const int k = blockIdx.x * RG_THREADS + threadIdx.x;
    if (k >= n_pairs) return;
    const T* src = x + (long long)__ldg(idx + k) * srow;
    T* dst;
    int ds;
    if constexpr (CM) {
        const int e = k / n;
        dst = out + (long long)e * c * n + (k - e * n);
        ds = n;
    } else {
        dst = out + (long long)k * c;
        ds = 1;
    }
    if constexpr (VW > 1) {
        for (int u = 0; u < c; u += VW) {
            T v[VW];
            load_vec<T, VW>(src + u, v);
            if constexpr (CM) {
#pragma unroll
                for (int j = 0; j < VW; ++j) dst[(long long)(u + j) * ds] = v[j];
            } else {
                store_vec<T, VW>(dst + u, v);
            }
        }
    } else {
#pragma unroll 4
        for (int u = 0; u < c; ++u) dst[(long long)u * ds] = src[u * sunk];
    }
}

// flat[idx[k] * c + u] += y[e, :, a] (CM: y + (e * c + u) * n + a; else y + k * c + u).
template <typename T, bool CM, int VW>
__global__ void __launch_bounds__(RG_THREADS)
    rows_scatter_add(const T* __restrict__ y, const int* __restrict__ idx, T* flat, int n_pairs, int n, int c)
{
    const int k = blockIdx.x * RG_THREADS + threadIdx.x;
    if (k >= n_pairs) return;
    T* dst = flat + (long long)__ldg(idx + k) * c;
    const T* src;
    int ss;
    if constexpr (CM) {
        const int e = k / n;
        src = y + (long long)e * c * n + (k - e * n);
        ss = n;
    } else {
        src = y + (long long)k * c;
        ss = 1;
    }
    for (int u = 0; u < c; u += VW) {
        T v[VW];
        if constexpr (!CM && VW > 1) {
            load_vec<T, VW>(src + u, v);
        } else {
#pragma unroll
            for (int j = 0; j < VW; ++j) v[j] = src[(long long)(u + j) * ss];
        }
        atomic_add_vec<T, VW>(dst + u, v);
    }
}

template <typename T, bool CM>
static const void* gather_for(int vw)
{
    if constexpr (sizeof(T) == 4) {
        if (vw == 4) return (const void*)rows_gather<T, CM, 4>;
    }
    if (vw == 2) return (const void*)rows_gather<T, CM, 2>;
    if (vw == 1) return (const void*)rows_gather<T, CM, 1>;
    return nullptr;
}

// f64 adds one unknown at a time: sm_90 has no vector atomic in f64.
template <typename T, bool CM>
static const void* scatter_for(int vw)
{
    if constexpr (sizeof(T) == 4) {
        if (vw == 4) return (const void*)rows_scatter_add<T, CM, 4>;
        if (vw == 2) return (const void*)rows_scatter_add<T, CM, 2>;
    }
    if (vw == 1) return (const void*)rows_scatter_add<T, CM, 1>;
    return nullptr;
}

static int launch(const void* fn, void** args, int n_pairs, int device, void* stream)
{
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    if (n_pairs == 0) return 0;
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return (int)guard.status;
    const dim3 grid((n_pairs + RG_THREADS - 1) / RG_THREADS);
    cudaError_t e = cudaLaunchKernel(fn, grid, dim3(RG_THREADS), args, 0, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <typename T>
static int gather(const T* x, long long srow, long long sunk, const int* idx, T* out, int n_pairs, int n, int c,
                  int channel_major, int vw, int device, void* stream)
{
    const void* fn = channel_major ? gather_for<T, true>(vw) : gather_for<T, false>(vw);
    void* args[] = {(void*)&x, &srow, &sunk, (void*)&idx, (void*)&out, &n_pairs, &n, &c};
    return launch(fn, args, n_pairs, device, stream);
}

template <typename T>
static int scatter(const T* y, const int* idx, T* flat, int n_pairs, int n, int c, int channel_major, int vw,
                   int device, void* stream)
{
    const void* fn = channel_major ? scatter_for<T, true>(vw) : scatter_for<T, false>(vw);
    void* args[] = {(void*)&y, (void*)&idx, (void*)&flat, &n_pairs, &n, &c};
    return launch(fn, args, n_pairs, device, stream);
}

extern "C" {

int rows_gather_f32(const float* x, long long srow, long long sunk, const int* idx, float* out, int n_pairs, int n,
                    int c, int channel_major, int vw, int device, void* stream)
{
    return gather<float>(x, srow, sunk, idx, out, n_pairs, n, c, channel_major, vw, device, stream);
}

int rows_gather_f64(const double* x, long long srow, long long sunk, const int* idx, double* out, int n_pairs,
                    int n, int c, int channel_major, int vw, int device, void* stream)
{
    return gather<double>(x, srow, sunk, idx, out, n_pairs, n, c, channel_major, vw, device, stream);
}

int rows_scatter_f32(const float* y, const int* idx, float* flat, int n_pairs, int n, int c, int channel_major,
                     int vw, int device, void* stream)
{
    return scatter<float>(y, idx, flat, n_pairs, n, c, channel_major, vw, device, stream);
}

int rows_scatter_f64(const double* y, const int* idx, double* flat, int n_pairs, int n, int c, int channel_major,
                     int vw, int device, void* stream)
{
    return scatter<double>(y, idx, flat, n_pairs, n, c, channel_major, vw, device, stream);
}

}  // extern "C"
