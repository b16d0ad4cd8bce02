// One banded sweep stage of the lattice operator apply, for Hopper (sm_90a):
//   out (M, N) = x (M, K1) @ T[:K1]  (+ x2 (M, K2) @ T[K1:])
// with T (K1 + K2, N) a banded interpolation or transposition table.
//
// Replaces the Pallas TPU kernel l3ster_tpu/ops/pallas_stages.py:kstacked_matmul
// (pallas_call at :166), the x/y stages of the reference's opt-in pipeline
// ops/lattice_sumfact.py:_apply_xy_pallas.
//
// What bounds it on this card: bytes.  At the bench (p = 6, 6^3 hexes) a stage
// moves 4.0-7.7 MB of x and out (1.2-2.3 us at 3.35 TB/s, 9.8 us for the six
// stages of an apply) against at most ~20 MFLOP of band arithmetic (0.3 us at
// 67 TFLOP/s on the CUDA cores).  So tensor cores cannot help, and the TPU
// kernel's bf16 hi/lo operand split (pallas_stages.py:_tstack3), which served
// its matrix unit only, is not carried over; TF32 would also break the f32
// gate.  The kernel computes in full f32 (f64 for the f64 entry) with FMAs.
//
// What else bounds it: a stage is small.  On this card an empty kernel takes
// about 2 us a launch and a torch copy of a stage's bytes 4.5-5.5 us (both
// timed beside the kernel by chip_smoke.py's stage phase, PERF.md), so a
// stage runs in one wave and its time is the latency of its blocks: every
// load a block needs is issued at once, and the arithmetic must not add
// shared-memory conflicts.
//
// Design.  Each output column n of a table has a band of nonzero rows per K
// half (7 of 37 for an interpolation table, 12-24 of 72 for a transposition
// half), given by the descriptor `band` (N, 4) = (first row, count) of each
// half, built on the host beside the table (ops/stages.py:band_descriptor).
// Columns go in groups of 4; the host also packs, once, each group's union
// of bands per half (`vals`, (ceil(N / 4), S1 + S2, 4), each column's values
// outside its own band zero), so no block gathers T.
// - One memory round trip: a block copies the descriptor, the packed bands
//   and its slab of bm = rgs * RM consecutive rows of x (and x2) into shared
//   memory by 16-byte cp.async.  A slab is one contiguous range of device
//   memory; where both K halves are whole 16-byte vectors (the transposition
//   tables, K = 72) its rows land at a padded stride of an odd number of
//   16-byte chunks, else contiguously at the source's offset modulo 16 bytes
//   (ragged ends and unaligned sources take 4- or 8-byte copies).
// - A thread owns one group of 4 columns for RM rows rg, rg + rgs, ...: per
//   band row it loads the group's 4 table values in one shared load and one
//   x value per row, and does 4 * RM FMAs, in ascending row order.  On the
//   padded path the 8 lanes of a quarter-warp take 8 consecutive rows of one
//   group and read 16 bytes of x each (V band rows at once), conflict-free,
//   with the group's union widened to whole vectors; otherwise (odd row
//   strides, conflict-free for scalars) the column group is fastest.
// - Outputs: 16-byte stores where N % 4 == 0; otherwise a slab's outputs are
//   gathered in shared memory and leave as one contiguous range in 16-byte
//   stores (rows of 37 values would leave as scattered 4-byte stores).
// - One block a slab.  ops/stages.py:launch_shape takes about 256 threads a
//   block and the most rows a thread that still gives ~0.7 slabs per SM, so
//   a bench stage is one wave of 96-191 blocks.  (Persistent blocks that
//   walk slabs, with the next slab's copy in flight, never ran faster at a
//   bench stage; PERF.md.)
// Skipping the exact zeros outside each column's band is the only change to
// the arithmetic of x @ T; it alone changes NaN/Inf propagation: a NaN or Inf
// of x in a row outside a column group's band union does not reach that
// group's outputs, where the full product gives NaN.
//
// Times (chip_smoke.py; NVIDIA H100 80GB HBM3, power limit 700 W), us, the
// bench's six stages x_interp, y_interp_ND, y_interp_N, y_transpose_NDT,
// y_transpose_NT, x_transpose_NDT: 5.20, 6.71, 5.30, 7.12, 5.52, 5.64, in sum
// 35.5 (plain 62.6, cuBLAS 65.1, byte bound 9.8; in the same run a torch copy
// of the same bytes 28.0, an empty kernel 2.0 a launch).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (l3ster_tpu_torch/ops/stages.py builds and loads it with ctypes).

#include <climits>

#include "async_copy.cuh"
#include "device_guard.cuh"

#define SB_MAX_THREADS 256

__device__ __forceinline__ void load4(const float* p, float (&v)[4])
{
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4])
{
    const double2 a = *reinterpret_cast<const double2*>(p), b = *reinterpret_cast<const double2*>(p + 2);
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4])
{
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double (&v)[4])
{
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// Values of T in 16 bytes, and n rounded up to a multiple of them.
template <typename T>
__host__ __device__ constexpr int vec16() { return 16 / (int)sizeof(T); }

template <typename T>
__host__ __device__ inline int round16(int n) { return (n + vec16<T>() - 1) / vec16<T>() * vec16<T>(); }

// Start copying the n contiguous values at src into buf (room for n + vec16 values):
// they land at buf + head, where head puts each value at its source's offset
// modulo 16 bytes, so all but the ragged ends go by 16-byte cp.async.  Returns
// buf + head.
template <typename T>
__device__ __forceinline__ T* copy_slab(T* buf, const T* src, int n, int tid, int nt)
{
    constexpr int V = vec16<T>();
    const int head = (int)(((size_t)src & 15) / sizeof(T));
    T* dst = buf + head;
    const int i0 = min(n, (V - head) % V);  // values before src's first 16-byte boundary
    const int nv = (n - i0) / V;
    const int tail = i0 + nv * V;
    for (int v = tid; v < nv; v += nt) cp_async<16>(dst + i0 + v * V, src + i0 + v * V, true);
    for (int e = tid; e < i0 + n - tail; e += nt) {
        const int i = e < i0 ? e : tail + (e - i0);
        cp_async<sizeof(T)>(dst + i, src + i, true);
    }
    return dst;
}

// V values of T in 16 bytes (4 floats or 2 doubles) from shared memory.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) { load4(p, v); }

__device__ __forceinline__ void load_vec(const double* p, double (&v)[2])
{
    const double2 a = *reinterpret_cast<const double2*>(p);
    v[0] = a.x, v[1] = a.y;
}

// The row stride of a vector slab in shared memory: k rounded up to whole
// 16-byte chunks, an odd number of them, so that 8 lanes reading 16 bytes from
// 8 consecutive rows hit 8 different groups of banks.
template <typename T>
__host__ __device__ inline int padded_row(int k)
{
    const int kp = round16<T>(k);
    return (kp / vec16<T>()) % 2 ? kp : kp + vec16<T>();
}

// Start copying `rows` rows of k values (k a multiple of 16 bytes) at src into
// dst with row stride kp: by 16-byte cp.async where src is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int kp, const T* src, int rows, int k, int tid, int nt)
{
    if (((size_t)src & 15) == 0) {
        const int q = k / vec16<T>();
        for (int e = tid; e < rows * q; e += nt) {
            const int r = e / q, c = (e % q) * vec16<T>();
            cp_async<16>(dst + r * kp + c, src + (size_t)r * k + c, true);
        }
    } else {
        for (int e = tid; e < rows * k; e += nt)
            cp_async<sizeof(T)>(dst + (e / k) * kp + e % k, src + e, true);
    }
}

// Store n values from shared src to global dst (src at dst's offset modulo 16
// bytes): 16-byte stores for all but the ragged ends.
template <typename T>
__device__ __forceinline__ void store_range(T* dst, const T* src, int n, int tid, int nt)
{
    constexpr int V = vec16<T>();
    const int head = (int)(((size_t)dst & 15) / sizeof(T));
    const int i0 = min(n, (V - head) % V);
    const int nv = (n - i0) / V, tail = i0 + nv * V;
    for (int v = tid; v < nv; v += nt)
        *reinterpret_cast<float4*>(dst + i0 + v * V) = *reinterpret_cast<const float4*>(src + i0 + v * V);
    for (int e = tid; e < i0 + n - tail; e += nt) {
        const int i = e < i0 ? e : tail + (e - i0);
        dst[i] = src[i];
    }
}

// The union of the bands of column group g in K half h, from the staged
// descriptor, widened to whole multiples of `align` rows: its first row *kb
// and its number of rows (0 for none).  ops/stages.py:band_descriptor packs
// the table's values by the same rule.
__device__ __forceinline__ int group_rows(const int* bd, int g, int h, int N, int align, int* kb)
{
    int lo = INT_MAX, hi = 0;
    for (int n = 4 * g; n < min(4 * g + 4, N); ++n) {
        const int s = bd[4 * n + 2 * h], c = bd[4 * n + 2 * h + 1];
        if (c > 0) lo = min(lo, s), hi = max(hi, s + c);
    }
    if (hi == 0) return *kb = 0;
    *kb = lo / align * align;
    return (hi + align - 1) / align * align - *kb;
}

// The outputs of one slab.  A thread takes (row group rg, column group g)
// items, with rows rg, rg + rgs, ...  VEC (row strides kp1, kp2 whole 16-byte
// chunks): rg is fastest, so the 8 lanes of each quarter-warp read 16 bytes
// of x from 8 consecutive rows, conflict-free, for V band rows at once;
// otherwise (odd row strides) g is fastest, so a warp's stores of one row
// are contiguous.
template <typename T, int RM, bool VEC>
__device__ __forceinline__ void slab_outputs(const T* xs, const T* xs2, int kp1, int kp2, const T* tp,
                                             const int* bd, T* out, T* tile, int m0, int rows, int N, int S1,
                                             int S2, int rgs)
{
    constexpr int V = VEC ? vec16<T>() : 1;
    const int ncg = (N + 3) / 4, S = S1 + S2;
    const bool vec = (N & 3) == 0 && ((size_t)out & 15) == 0;
    // rows of N % 4 != 0 values go through the tile, at out's offset modulo 16 bytes
    T* ot = tile ? tile + ((size_t)(out + (size_t)m0 * N) & 15) / sizeof(T) : nullptr;
    for (int item = threadIdx.x; item < rgs * ncg; item += blockDim.x) {
        const int rg = VEC ? item % rgs : item / ncg, g = VEC ? item / rgs : item % ncg;
        if (rg >= rows) continue;
        T acc[RM][4];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] = 0;
        for (int h = 0; h < 2; ++h) {
            int kb;
            const int L = group_rows(bd, g, h, N, V, &kb);
            if (L == 0) continue;
            const int kp = h ? kp2 : kp1;
            const T* xb = (h ? xs2 : xs) + kb;
            const T* tb = tp + ((size_t)g * S + (h ? S1 : 0)) * 4;
            int off[RM];
#pragma unroll
            for (int i = 0; i < RM; ++i) off[i] = min(rg + i * rgs, rows - 1) * kp;
#pragma unroll 2
            for (int j = 0; j < L; j += V) {
                T xv[RM][V];
#pragma unroll
                for (int i = 0; i < RM; ++i) {
                    if constexpr (VEC)
                        load_vec(xb + off[i] + j, xv[i]);
                    else
                        xv[i][0] = xb[off[i] + j];
                }
#pragma unroll
                for (int jj = 0; jj < V; ++jj) {
                    T t[4];
                    load4(tb + 4 * (j + jj), t);
#pragma unroll
                    for (int i = 0; i < RM; ++i)
#pragma unroll
                        for (int c = 0; c < 4; ++c) acc[i][c] = fma(xv[i][jj], t[c], acc[i][c]);
                }
            }
        }
        const int n0 = 4 * g;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            if (rg + i * rgs >= rows) break;
            T* o = ot ? ot + (size_t)(rg + i * rgs) * N + n0 : out + (size_t)(m0 + rg + i * rgs) * N + n0;
            if (vec) {
                store4(o, acc[i]);
            } else {
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    if (n0 + c < N) o[c] = acc[i][c];
            }
        }
    }
    if (ot) {  // the slab's rows of out are one contiguous range
        __syncthreads();
        store_range(out + (size_t)m0 * N, ot, rows * N, threadIdx.x, blockDim.x);
    }
}

// Block b computes slab b: rows [b * bm, b * bm + bm) of out, bm = rgs * RM.
template <typename T, int RM, bool VEC>
__global__ void __launch_bounds__(SB_MAX_THREADS) stage_band_kernel(
    const T* __restrict__ x, const T* __restrict__ x2, const T* __restrict__ vals, const int* __restrict__ band,
    T* __restrict__ out, int M, int K1, int K2, int N, int S1, int S2, int rgs)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int ncg = (N + 3) / 4, S = S1 + S2;
    const int bm = rgs * RM, m0 = blockIdx.x * bm, rows = min(bm, M - m0);
    const int tid = threadIdx.x, nt = blockDim.x;
    const int kp1 = VEC ? padded_row<T>(K1) : K1, kp2 = VEC && K2 ? padded_row<T>(K2) : K2;
    const int xlen = VEC ? bm * kp1 : round16<T>(bm * K1 + vec16<T>());
    T* tp = reinterpret_cast<T*>(smem_raw);                      // (ncg, S, 4) the packed bands
    int* bd = reinterpret_cast<int*>(tp + (size_t)ncg * S * 4);  // (N, 4) the descriptor
    T* tile = N & 3 ? reinterpret_cast<T*>(bd + 4 * N) : nullptr;  // a slab's outputs, N % 4 != 0
    T* xb = reinterpret_cast<T*>(bd + 4 * N) + (tile ? round16<T>(bm * N + vec16<T>()) : 0);  // the slab

    // one round trip: descriptor, packed bands and the slab of x (and x2)
    for (int n = tid; n < N; n += nt) cp_async<16>(bd + 4 * n, band + 4 * n, true);
    copy_slab(tp, vals, ncg * S * 4, tid, nt);  // 16-byte aligned: lands at tp
    const T *xs, *xs2 = nullptr;
    if constexpr (VEC) {
        copy_rows(xb, kp1, x + (size_t)m0 * K1, rows, K1, tid, nt);
        if (K2) copy_rows(xb + xlen, kp2, x2 + (size_t)m0 * K2, rows, K2, tid, nt);
        xs = xb, xs2 = K2 ? xb + xlen : nullptr;
    } else {
        xs = copy_slab(xb, x + (size_t)m0 * K1, rows * K1, tid, nt);
        if (K2) xs2 = copy_slab(xb + xlen, x2 + (size_t)m0 * K2, rows * K2, tid, nt);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    slab_outputs<T, RM, VEC>(xs, xs2, kp1, kp2, tp, bd, out, tile, m0, rows, N, S1, S2, rgs);
}

template <typename T, bool VEC>
static void* kernel_rm(int rm)
{
    if (rm == 1) return (void*)stage_band_kernel<T, 1, VEC>;
    if (rm == 2) return (void*)stage_band_kernel<T, 2, VEC>;
    if (rm == 4) return (void*)stage_band_kernel<T, 4, VEC>;
    if (rm == 8) return (void*)stage_band_kernel<T, 8, VEC>;
    return nullptr;
}

template <typename T>
static void* kernel_for(int rm, int vec)
{
    return vec ? kernel_rm<T, true>(rm) : kernel_rm<T, false>(rm);
}

template <typename T>
static int launch(const T* x, const T* x2, const T* vals, const int* band, T* out, int M, int K1, int K2, int N,
                  int S1, int S2, int rm, int vec, int rgs, int threads, int smem, int device, void* stream)
{
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return (int)guard.status;
    void* fn = kernel_for<T>(rm, vec);
    if (fn == nullptr || threads > SB_MAX_THREADS) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    void* args[] = {&x, &x2, &vals, &band, &out, &M, &K1, &K2, &N, &S1, &S2, &rgs};
    const int slabs = (M + rgs * rm - 1) / (rgs * rm);  // one block a slab
    cudaError_t e = cudaLaunchKernel(fn, dim3(slabs), dim3(threads), args, (size_t)smem, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

extern "C" {

int stage_band_f32(const float* x, const float* x2, const float* vals, const int* band, float* out, int M,
                   int K1, int K2, int N, int S1, int S2, int rm, int vec, int rgs, int threads, int smem,
                   int device, void* stream)
{
    return launch<float>(x, x2, vals, band, out, M, K1, K2, N, S1, S2, rm, vec, rgs, threads, smem, device,
                         stream);
}

int stage_band_f64(const double* x, const double* x2, const double* vals, const int* band, double* out, int M,
                   int K1, int K2, int N, int S1, int S2, int rm, int vec, int rgs, int threads, int smem,
                   int device, void* stream)
{
    return launch<double>(x, x2, vals, band, out, M, K1, K2, N, S1, S2, rm, vec, rgs, threads, smem, device,
                          stream);
}

// Resident blocks per SM of one instantiation at this launch shape, or -(CUDA error).
int stage_band_occupancy(int f64, int rm, int vec, int threads, int smem, int device)
{
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return -(int)guard.status;
    void* fn = f64 ? kernel_for<double>(rm, vec) : kernel_for<float>(rm, vec);
    if (fn == nullptr) return -(int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return -(int)e;
    }
    int blocks = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, (size_t)smem);
    return e == cudaSuccess ? blocks : -(int)e;
}

}  // extern "C"
