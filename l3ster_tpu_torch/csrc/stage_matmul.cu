// One banded sweep stage of the lattice operator apply, for Hopper (sm_90a):
//   out (M, N) = x (M, K1) @ T[:K1]  (+ x2 (M, K2) @ T[K1:])
// with T (K1 + K2, N) a banded interpolation or transposition table.
//
// Replaces the Pallas TPU kernel l3ster_tpu/ops/pallas_stages.py:kstacked_matmul
// (pallas_call at :166), the x/y stages of the reference's opt-in pipeline
// ops/lattice_sumfact.py:_apply_xy_pallas.  The TPU kernel splits f32 into bf16
// hi/lo halves to feed its matrix unit; this one computes in full f32 (or f64).
//
// What bounds it on this card: the shapes are skinny (K and N of 37 to 288, M of
// thousands of rows) so the work is a few MB of x and out against tens of MFLOP:
// bytes bound it, and at the bench a call moves about 4 MB (about 1.2 us at
// 3.35 TB/s), so its launch cost is of the same size as its work.  The design
// is the plain tiled GEMM: a block computes a 64 x 64 tile of out, staging
// 16-deep slices of x (or of the K-concat [x | x2]) and of T in shared memory,
// and each of its 256 threads keeps a 4 x 4 micro-tile in registers.  Ragged
// edges are masked; nothing is assumed about the band of T.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (l3ster_tpu_torch/ops/stages.py builds and loads it with ctypes).

#include "device_guard.cuh"

#define SM_BM 64
#define SM_BN 64
#define SM_BK 16
#define SM_TX 16  // threads along N
#define SM_TY 16  // threads along M

template <typename T>
__global__ void __launch_bounds__(SM_TX * SM_TY) stage_matmul_kernel(
    const T* __restrict__ x, const T* __restrict__ x2, const T* __restrict__ tab,
    T* __restrict__ out, int M, int K1, int K2, int N)
{
    __shared__ T xs[SM_BK][SM_BM + 1];  // xs[k][m]; +1 spreads the transposed stores
    __shared__ T ts[SM_BK][SM_BN];      // ts[k][n]
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * SM_TX + tx;
    const int m0 = blockIdx.y * SM_BM, n0 = blockIdx.x * SM_BN;
    const int K = K1 + K2;
    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int k0 = 0; k0 < K; k0 += SM_BK) {
        for (int idx = tid; idx < SM_BM * SM_BK; idx += SM_TX * SM_TY) {
            const int mm = idx / SM_BK, kk = idx % SM_BK;  // neighbouring threads: neighbouring k
            const int m = m0 + mm, k = k0 + kk;
            T v = 0;
            if (m < M && k < K) v = k < K1 ? x[(size_t)m * K1 + k] : x2[(size_t)m * K2 + (k - K1)];
            xs[kk][mm] = v;
        }
        for (int idx = tid; idx < SM_BK * SM_BN; idx += SM_TX * SM_TY) {
            const int kk = idx / SM_BN, nn = idx % SM_BN;
            const int k = k0 + kk, n = n0 + nn;
            ts[kk][nn] = (k < K && n < N) ? tab[(size_t)k * N + n] : (T)0;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < SM_BK; ++kk) {
            T av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = xs[kk][ty + SM_TY * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = ts[kk][tx + SM_TX * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + SM_TY * i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx + SM_TX * j;
            if (n < N) out[(size_t)m * N + n] = acc[i][j];
        }
    }
}

template <typename T>
static int launch(const T* x, const T* x2, const T* tab, T* out, int M, int K1, int K2, int N,
                  int device, void* stream)
{
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return (int)guard.status;
    dim3 block(SM_TX, SM_TY);
    dim3 grid((N + SM_BN - 1) / SM_BN, (M + SM_BM - 1) / SM_BM);
    stage_matmul_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(x, x2, tab, out, M, K1, K2, N);
    return (int)cudaGetLastError();
}

extern "C" {

int stage_matmul_f32(const float* x, const float* x2, const float* tab, float* out, int M, int K1,
                     int K2, int N, int device, void* stream)
{
    return launch<float>(x, x2, tab, out, M, K1, K2, N, device, stream);
}

int stage_matmul_f64(const double* x, const double* x2, const double* tab, double* out, int M,
                     int K1, int K2, int N, int device, void* stream)
{
    return launch<double>(x, x2, tab, out, M, K1, K2, N, device, stream);
}

}  // extern "C"
