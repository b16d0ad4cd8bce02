// Fused sum-factorized local operator apply (constant A), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel l3ster_tpu/ops/pallas_sumfact.py:sumfact_const_apply_pallas
// (pallas_call at :195).  Per element (one block each), in 2D or 3D:
//   1. nodes -> QPs: 1D sweeps along x, y[, z] with the (q1, n1) tables N1, D1 give
//      the values v and the reference derivatives (ddx, ddy[, ddz]) at the q1^dim QPs;
//   2. per QP: g = (v, J^-T (ddx, ddy, ddz)); r_i = w * sum A[d,i,u] g[d,u];
//      t[d,u] = sum_i A[d,i,u] r_i; t_ref = J^-1 (t_1..t_dim);
//   3. QPs -> nodes: the exact transpose sweeps, written to y.
// x and y are (E, n1^dim, c) in lexicographic node order (x fastest), J^-1 is
// (E, Q, dim, dim) and w is (E, Q), with QP index qx + q1*qy + q1^2*qz.
//
// What bounds it on this card: bytes.  At p = 4 (n1 = 5, q1 = 8, c = 4) an element
// reads 500 + 4608 + 512 values, writes 500, and does ~380 kFLOP, so ~6.6 GFLOP
// against ~430 MB over the 17,456-hex cylinder mesh: both bounds are near 0.1 ms,
// the bytes slightly above.  Everything between x and y stays in shared memory:
// the element's nodal tile, every sweep stage and the QP tensors (8,192 values at
// p = 4, 3D; about 64 KB in all in f32, 128 KB in f64), sized at launch.  The
// sweeps are loops over the table entries (no unrolling, so any order compiles;
// the TPU kernel unrolled them and stopped at p ~ 4).  The per-QP step
// (const_coeffs.cuh) works in place on the QP tensors; r lives in a per-thread
// column of shared memory; A's nonzeros are in __constant__ memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (l3ster_tpu_torch/ops/sumfact_fused.py builds and loads it with ctypes).

#include "const_coeffs.cuh"

#define SF_THREADS 256

// One 1D contraction stage over a (A, I, B) tensor into (A, O, B):
//   out[a, o, b] = sum_i tab1[o*so + i*si] * in1[a, i, b]  (+ the same with tab2, in2)
// so = I, si = 1 reads a (O, I) table forwards; so = 1, si = O reads an (I, O) one transposed.
template <typename T>
__device__ void contract(T* __restrict__ out, const T* __restrict__ in1, const T* __restrict__ tab1,
                         const T* __restrict__ in2, const T* __restrict__ tab2,
                         int A, int I, int O, int B, int so, int si)
{
    const int total = A * O * B;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
        const int b = idx % B, ao = idx / B;
        const int o = ao % O, a = ao / O;
        const size_t off = (size_t)a * I * B + b;
        T s = 0;
        for (int i = 0; i < I; ++i) s += tab1[o * so + i * si] * in1[off + (size_t)i * B];
        if (in2 != nullptr)
            for (int i = 0; i < I; ++i) s += tab2[o * so + i * si] * in2[off + (size_t)i * B];
        out[idx] = s;
    }
}

template <typename T, int DIM>
__global__ void __launch_bounds__(SF_THREADS) sumfact_kernel(
    const T* __restrict__ x, const T* __restrict__ ji, const T* __restrict__ w,
    const T* __restrict__ N1, const T* __restrict__ D1, T* __restrict__ y,
    int n1, int q1, int c, int n_eq)
{
    constexpr int D1N = DIM + 1;
    const int e = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    int nn = 1, Q = 1;
#pragma unroll
    for (int d = 0; d < DIM; ++d) { nn *= n1; Q *= q1; }
    const int nb = nn / n1;          // n1^(dim-1)
    const int s1 = nb * q1 * c;      // one x-stage tensor: (.., qx, c)
    const int s2 = n1 * q1 * q1 * c; // one y-stage tensor of 3D: (z, qy, qx, c)
    const int qc = Q * c;            // one QP tensor: (q, c)

    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* tN = reinterpret_cast<T*>(smem_raw);  // (q1, n1)
    T* tD = tN + q1 * n1;                    // (q1, n1)
    T* X = tD + q1 * n1;                     // (n1^dim, c) nodal tile, then y
    T* S1 = X + nn * c;                      // 2 x-stage tensors
    T* S2 = S1 + 2 * s1;                     // 3 y-stage tensors (3D only)
    T* S3 = S2 + (DIM == 3 ? 3 * s2 : 0);    // dim+1 QP tensors
    T* R = S3 + D1N * qc;                    // (n_eq, nt): w * r of each thread's QP

    for (int k = tid; k < q1 * n1; k += nt) {
        tN[k] = N1[k];
        tD[k] = D1[k];
    }
    const T* xe = x + (size_t)e * nn * c;
    for (int k = tid; k < nn * c; k += nt) X[k] = xe[k];
    __syncthreads();

    // ---- nodes -> QPs; S3 holds (v, ddx, ddy[, ddz]), each (q, c)
    T* ax = S1;
    T* adx = S1 + s1;
    contract(ax, X, tN, (const T*)nullptr, tN, nb, n1, q1, c, n1, 1);  // x: (.., x, c) -> (.., qx, c)
    contract(adx, X, tD, (const T*)nullptr, tD, nb, n1, q1, c, n1, 1);
    __syncthreads();
    if (DIM == 3) {
        T *b = S2, *bdy = S2 + s2, *bdx = S2 + 2 * s2;
        contract(b, ax, tN, (const T*)nullptr, tN, n1, n1, q1, q1 * c, n1, 1);  // y
        contract(bdy, ax, tD, (const T*)nullptr, tD, n1, n1, q1, q1 * c, n1, 1);
        contract(bdx, adx, tN, (const T*)nullptr, tN, n1, n1, q1, q1 * c, n1, 1);
        __syncthreads();
        contract(S3, b, tN, (const T*)nullptr, tN, 1, n1, q1, q1 * q1 * c, n1, 1);  // z
        contract(S3 + 3 * qc, b, tD, (const T*)nullptr, tD, 1, n1, q1, q1 * q1 * c, n1, 1);
        contract(S3 + 2 * qc, bdy, tN, (const T*)nullptr, tN, 1, n1, q1, q1 * q1 * c, n1, 1);
        contract(S3 + qc, bdx, tN, (const T*)nullptr, tN, 1, n1, q1, q1 * q1 * c, n1, 1);
    } else {
        contract(S3, ax, tN, (const T*)nullptr, tN, 1, n1, q1, q1 * c, n1, 1);  // y
        contract(S3 + 2 * qc, ax, tD, (const T*)nullptr, tD, 1, n1, q1, q1 * c, n1, 1);
        contract(S3 + qc, adx, tN, (const T*)nullptr, tN, 1, n1, q1, q1 * c, n1, 1);
    }
    __syncthreads();

    // ---- per QP, in place: S3 becomes (t0, t_ref x, t_ref y[, t_ref z])
    T* rs = R + tid;
    for (int q = tid; q < Q; q += nt) {
        const T* jq = ji + ((size_t)e * Q + q) * DIM * DIM;
        T J[DIM][DIM];
#pragma unroll
        for (int j = 0; j < DIM; ++j)
#pragma unroll
            for (int i = 0; i < DIM; ++i) J[j][i] = jq[j * DIM + i];
        ca_qp_step<T, DIM>(S3 + q * c, qc, 1, J, w[(size_t)e * Q + q], rs, nt, c, n_eq);
    }
    __syncthreads();

    // ---- QPs -> nodes (transposed tables: so = 1, si = n1)
    T* t0 = S3;
    T* tx = S3 + qc;
    T* ty = S3 + 2 * qc;
    T* a = S1;
    T* ax2 = S1 + s1;
    if (DIM == 3) {
        T* tz = S3 + 3 * qc;
        T *b = S2, *by = S2 + s2, *bx = S2 + 2 * s2;
        contract(b, t0, tN, tz, tD, 1, q1, n1, q1 * q1 * c, 1, n1);  // z
        contract(by, ty, tN, (const T*)nullptr, tN, 1, q1, n1, q1 * q1 * c, 1, n1);
        contract(bx, tx, tN, (const T*)nullptr, tN, 1, q1, n1, q1 * q1 * c, 1, n1);
        __syncthreads();
        contract(a, b, tN, by, tD, n1, q1, n1, q1 * c, 1, n1);  // y
        contract(ax2, bx, tN, (const T*)nullptr, tN, n1, q1, n1, q1 * c, 1, n1);
    } else {
        contract(a, t0, tN, ty, tD, 1, q1, n1, q1 * c, 1, n1);  // y
        contract(ax2, tx, tN, (const T*)nullptr, tN, 1, q1, n1, q1 * c, 1, n1);
    }
    __syncthreads();
    contract(y + (size_t)e * nn * c, a, tN, ax2, tD, nb, q1, n1, c, 1, n1);  // x, to device memory
}

template <typename T, int DIM>
static int launch(const T* x, const T* ji, const T* w, const T* N1, const T* D1, T* y, int E,
                  int n1, int q1, int c, int n_eq, int smem, int device, void* stream)
{
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return (int)guard.status;
    cudaError_t e = cudaFuncSetAttribute(sumfact_kernel<T, DIM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sumfact_kernel<T, DIM><<<E, SF_THREADS, smem, (cudaStream_t)stream>>>(
        x, ji, w, N1, D1, y, n1, q1, c, n_eq);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const T* x, const T* ji, const T* w, const T* N1, const T* D1, T* y, int E,
                    int n1, int q1, int c, int dim, int n_eq, int smem, int device, void* stream)
{
    if (dim == 2) return launch<T, 2>(x, ji, w, N1, D1, y, E, n1, q1, c, n_eq, smem, device, stream);
    if (dim == 3) return launch<T, 3>(x, ji, w, N1, D1, y, E, n1, q1, c, n_eq, smem, device, stream);
    return (int)cudaErrorInvalidValue;
}

CA_EXPORTS(sf)

extern "C" {

int sf_threads() { return SF_THREADS; }

int sf_f32(const float* x, const float* ji, const float* w, const float* N1, const float* D1,
           float* y, int E, int n1, int q1, int c, int dim, int n_eq, int smem, int device,
           void* stream)
{
    return dispatch<float>(x, ji, w, N1, D1, y, E, n1, q1, c, dim, n_eq, smem, device, stream);
}

int sf_f64(const double* x, const double* ji, const double* w, const double* N1, const double* D1,
           double* y, int E, int n1, int q1, int c, int dim, int n_eq, int smem, int device,
           void* stream)
{
    return dispatch<double>(x, ji, w, N1, D1, y, E, n1, q1, c, dim, n_eq, smem, device, stream);
}

}  // extern "C"
