// Per-QP least-squares algebra of the dense-basis operator apply, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel l3ster_tpu/ops/pallas_qp.py:qp_algebra_const_pallas
// (pallas_call at :94).  Between the two basis matmuls of the dense apply
// (G = X B^T, Y = T B), every quadrature point k = e * Q + q runs, for a constant A:
//   g_phys = (g_0, J^-T (g_1..g_dim))   per unknown u
//   r_i    = w * sum_{d,u} A[d,i,u] g_phys[d,u]
//   t[d,u] = sum_i A[d,i,u] r_i
//   T      = (t_0, J^-1 (t_1..t_dim))   per unknown u
// G and T are read and written in the matmuls' own (E, c, d1, Q) layout, so the
// (d1*c, EQ) relayout that the TPU kernel needs before and after it (two device
// round trips of G and T) does not exist here.  J^-1 is (dim, dim, EQ), plane
// j * dim + i holding Jinv[j, i]; w is (EQ,).
//
// What bounds it on this card: bytes.  Per QP it reads 2*(dim+1)*c + dim^2 + 1 values
// and writes (dim+1)*c, against ~200 FLOPs (f32: ~1.5 GB and ~2 GFLOP at the p=4
// cylinder).  One thread per QP, neighbouring threads on neighbouring q, so every
// load and store is coalesced; J^-1 stays in registers; the QP's g and r, which the
// nonzero entries of A index at run time, live in a per-thread column of shared
// memory ([slot][thread], no bank conflicts), where the per-QP step of
// const_coeffs.cuh works in place.  A's nonzeros are in __constant__ memory
// (const_coeffs.cuh), so zeros cost nothing and one build serves every A.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (l3ster_tpu_torch/ops/qp.py builds and loads it with ctypes).

#include "const_coeffs.cuh"

#define QP_THREADS 256

template <typename T, int DIM>
__global__ void __launch_bounds__(QP_THREADS) qp_kernel(
    const T* __restrict__ G, const T* __restrict__ ji, const T* __restrict__ w,
    T* __restrict__ Tout, int EQ, int Q, int c, int n_eq)
{
    constexpr int D1 = DIM + 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nt = blockDim.x, tid = threadIdx.x;
    T* gs = reinterpret_cast<T*>(smem_raw) + tid;  // this QP's g[d, u] at gs[(d * c + u) * nt]
    T* rs = gs + (size_t)D1 * c * nt;              // w * r_i at rs[i * nt]

    const int k = blockIdx.x * nt + tid;
    if (k >= EQ) return;  // no barrier below: each thread owns its shared column
    const int e = k / Q, q = k - e * Q;
    const size_t base = (size_t)e * c * D1 * Q + q;  // G[e, u, d, q] = G[base + (u * D1 + d) * Q]

    T J[DIM][DIM];
#pragma unroll
    for (int j = 0; j < DIM; ++j)
#pragma unroll
        for (int i = 0; i < DIM; ++i) J[j][i] = ji[(size_t)(j * DIM + i) * EQ + k];

    for (int u = 0; u < c; ++u)
#pragma unroll
        for (int d = 0; d < D1; ++d) gs[(d * c + u) * nt] = G[base + (size_t)(u * D1 + d) * Q];
    ca_qp_step<T, DIM>(gs, c * nt, nt, J, w[k], rs, nt, c, n_eq);
    for (int u = 0; u < c; ++u)
#pragma unroll
        for (int d = 0; d < D1; ++d) Tout[base + (size_t)(u * D1 + d) * Q] = gs[(d * c + u) * nt];
}

template <typename T, int DIM>
static int launch(const T* G, const T* ji, const T* w, T* Tout, int EQ, int Q, int c, int n_eq,
                  int smem, int device, void* stream)
{
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return (int)guard.status;
    cudaError_t e = cudaFuncSetAttribute(qp_kernel<T, DIM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const int grid = (EQ + QP_THREADS - 1) / QP_THREADS;
    qp_kernel<T, DIM><<<grid, QP_THREADS, smem, (cudaStream_t)stream>>>(G, ji, w, Tout, EQ, Q, c, n_eq);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const T* G, const T* ji, const T* w, T* Tout, int EQ, int Q, int c, int dim,
                    int n_eq, int smem, int device, void* stream)
{
    if (dim == 2) return launch<T, 2>(G, ji, w, Tout, EQ, Q, c, n_eq, smem, device, stream);
    if (dim == 3) return launch<T, 3>(G, ji, w, Tout, EQ, Q, c, n_eq, smem, device, stream);
    return (int)cudaErrorInvalidValue;
}

CA_EXPORTS(qp)

extern "C" {

int qp_threads() { return QP_THREADS; }

int qp_f32(const float* G, const float* ji, const float* w, float* Tout, int EQ, int Q, int c,
           int dim, int n_eq, int smem, int device, void* stream)
{
    return dispatch<float>(G, ji, w, Tout, EQ, Q, c, dim, n_eq, smem, device, stream);
}

int qp_f64(const double* G, const double* ji, const double* w, double* Tout, int EQ, int Q, int c,
           int dim, int n_eq, int smem, int device, void* stream)
{
    return dispatch<double>(G, ji, w, Tout, EQ, Q, c, dim, n_eq, smem, device, stream);
}

}  // extern "C"
