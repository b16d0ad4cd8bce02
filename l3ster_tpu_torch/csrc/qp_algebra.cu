// Per-QP least-squares algebra of the dense-basis operator apply, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel l3ster_tpu/ops/pallas_qp.py:qp_algebra_const_pallas
// (pallas_call at :94).  Between the two basis matmuls of the dense apply
// (G = X B^T, Y = T B), every quadrature point k = e * Q + q runs, for a constant A:
//   g_phys = (g_0, J^-T (g_1..g_dim))   per unknown u
//   r_i    = w * sum_{d,u} A[d,i,u] g_phys[d,u]
//   t[d,u] = sum_i A[d,i,u] r_i
//   T      = (t_0, J^-1 (t_1..t_dim))   per unknown u
// One source, two layouts of G and T, each read and written in place (a template
// flag picks the offsets, so neither caller pays a relayout pass over G or T, whose
// traffic is the kernel's whole bound):
//   dense:   (E, c, d1, Q), the dense apply's basis matmuls' own layout
//            (ops/qp.py:qp_algebra_const);
//   lattice: (d1*c, EQ), rows d*c+u, the TPU kernel's layout, which the non-fused
//            lattice chain builds as a row concatenation [v; d_x; d_y(; d_z)]
//            (l3ster_tpu/ops/lattice_sumfact.py:624-646; ops/qp.py:qp_algebra_const_lattice).
// J^-1 is (dim, dim, EQ), plane j * dim + i holding Jinv[j, i]; w is (EQ,).
//
// What bounds it on this card: bytes.  Per QP it reads 2*(dim+1)*c + dim^2 + 1 values
// and writes (dim+1)*c, against ~200 FLOPs (f32: ~1.5 GB and ~2 GFLOP at the p=4
// cylinder).  The design keeps enough bytes in flight on every SM, whatever the shape:
// - Tiles of QP_TILE consecutive QPs, or of 128, 64 or 32 where one tile of 256 does
//   not fit in shared memory (wide stackings in f64: one QP a thread, the block as
//   wide as the tile, a template variant of the flat step below; ops/qp.py:launch_shape
//   picks the largest that fits).  A tile is R = (dim+1)*c + dim^2 + 1 row segments
//   (the lattice layout's rows, or the dense layout's (u, d) rows of each element it
//   spans), copied into shared memory by cp.async, 16 bytes at a time where the host
//   found every pointer 16-byte aligned and EQ (lattice) or Q (dense) a multiple of
//   the vector width, else one value at a time (a run-time flag of the same kernel).
//   The dense layout's element index comes from a multiply-shift division by Q.
// - A persistent grid: as many blocks as fit on the card, each walking tiles with a
//   stride of the grid through a ring of three tiles: two tiles' copies are in flight
//   while one computes and stores, and a tile's refill starts as soon as it is in.
//   A shape of 1.4 waves no longer leaves a tail wave of idle SMs.  Where three tiles
//   do not fit in shared memory, two (refilled after the stores), else one: the host
//   picks the depth (ops/qp.py:launch_shape).
// - The per-QP step on the tile in shared memory, QP_NQ QPs a thread; thread t takes
//   QPs t + m * QP_THREADS, so every shared access is conflict-free.  In f32 with
//   c = 1, 3 or 4 (compile-time) it runs in registers (qp_step_registers): the QP's
//   (d+1)*c values are loaded once, A is dense in shared memory (zeros included, one
//   broadcast load per entry for all the thread's QPs), every multiply-add independent
//   of the last.  Otherwise (f64, where those registers would spill, and any other c)
//   A's nonzeros are flat records built once per block (const_coeffs.cuh:
//   ca_stage_flat, ca_qp_step_flat), each a dependent shared load.  Both keep the
//   sums of ca_qp_step in the same order.  In f32 the register step with the ring of
//   three timed faster than the flat step with a ring of two or three at every shape
//   the paths run (PERF.md section 6).
// - Stores as 16-byte vectors (or single values) from the tile in shared memory;
//   a masked ragged tail (zero-filled copies compute zeros).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (l3ster_tpu_torch/ops/qp.py builds and loads it with ctypes).

#include "async_copy.cuh"
#include "const_coeffs.cuh"

constexpr int QP_THREADS = 128;  // threads a block
constexpr int QP_NQ = 2;          // QPs a thread takes through the per-QP step at once
constexpr int QP_TILE = QP_THREADS * QP_NQ;  // QPs a tile (read by ops/qp.py through qp_tile)
// registers are capped for 512 resident threads an SM (128 a thread)

// n / d for 0 <= n < 2^31 from the host's (mul, shr) of d (mul == 0: d == 1).
__device__ __forceinline__ int fast_div(int n, unsigned mul, int shr)
{
    return mul ? (int)(__umulhi((unsigned)n, mul) >> shr) : n;
}

// The per-QP step of QP_NQ QPs of a tile in shared memory (QP q = tid + m * QP_THREADS,
// slot s = d * C + u at buf[s * QP_TILE + q]), in place, with every value of a QP in
// registers: C is compile-time, so the slots are register indices; A is dense in
// shared memory, Ad[i * S + s] (zeros included), read once per equation for all of
// the thread's QPs.  The sums are those of ca_qp_step in the same order (slots
// ascending in r_i, equations ascending in t[s]), the zeros adding nothing.
template <typename T, int DIM, int C>
__device__ __forceinline__ void qp_step_registers(T* buf, int tid, const T (&J)[QP_NQ][DIM][DIM],
                                                  const T (&w)[QP_NQ], const T* Ad, int n_eq)
{
    constexpr int S = (DIM + 1) * C;
    T g[QP_NQ][S], t[QP_NQ][S];
#pragma unroll
    for (int m = 0; m < QP_NQ; ++m) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
            g[m][s] = buf[s * QP_TILE + tid + m * QP_THREADS];
            t[m][s] = 0;
        }
#pragma unroll
        for (int u = 0; u < C; ++u) {  // g_phys = J^-T g_ref
            T rd[DIM];
#pragma unroll
            for (int j = 0; j < DIM; ++j) rd[j] = g[m][(1 + j) * C + u];
#pragma unroll
            for (int i = 0; i < DIM; ++i) {
                T sum = 0;
#pragma unroll
                for (int j = 0; j < DIM; ++j) sum += J[m][j][i] * rd[j];
                g[m][(1 + i) * C + u] = sum;
            }
        }
    }
    for (int i = 0; i < n_eq; ++i) {
        const T* a = Ad + i * S;
        T r[QP_NQ];
#pragma unroll
        for (int m = 0; m < QP_NQ; ++m) r[m] = 0;
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const T v = a[s];
#pragma unroll
            for (int m = 0; m < QP_NQ; ++m) r[m] += v * g[m][s];
        }
#pragma unroll
        for (int m = 0; m < QP_NQ; ++m) r[m] *= w[m];
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const T v = a[s];
#pragma unroll
            for (int m = 0; m < QP_NQ; ++m) t[m][s] += v * r[m];
        }
    }
#pragma unroll
    for (int m = 0; m < QP_NQ; ++m) {
        T* bq = buf + tid + m * QP_THREADS;
#pragma unroll
        for (int u = 0; u < C; ++u) {  // t_ref = J^-1 (t_1..t_DIM)
            bq[u * QP_TILE] = t[m][u];
#pragma unroll
            for (int j = 0; j < DIM; ++j) {
                T sum = 0;
#pragma unroll
                for (int i = 0; i < DIM; ++i) sum += J[m][j][i] * t[m][(1 + i) * C + u];
                bq[((1 + j) * C + u) * QP_TILE] = sum;
            }
        }
    }
}

// NQ QPs a thread; NT threads a block (0: the launch's block width, for the smaller
// tiles).  A tile is NT * NQ QPs.
template <typename T, int DIM, int C, bool LAT, int NQ, int NT>
__global__ void __launch_bounds__(QP_THREADS, 512 / QP_THREADS) qp_kernel(
    const T* __restrict__ G, const T* __restrict__ ji, const T* __restrict__ w,
    T* __restrict__ Tout, int EQ, int Q, int c_rt, int n_eq, int vec, int nbuf, unsigned qmul, int qshr)
{
    constexpr int D1 = DIM + 1, VQ = 16 / sizeof(T);
    // the register step where c is compiled (f32 only, see kernel_for_c), else the flat records
    constexpr bool REG = C != 0;
    static_assert(!REG || (NQ == QP_NQ && NT == QP_THREADS), "the register step runs the 256-QP tile");
    const int nthr = NT ? NT : (int)blockDim.x, tile = nthr * NQ;
    const int c = C ? C : c_rt, S = D1 * c, R = S + DIM * DIM + 1;
    const int tid = threadIdx.x;
    const int vq = vec ? VQ : 1, ch = tile / vq, lg = __ffs(ch) - 1;  // values a copy, copies a row (2^lg)
    const int n_tiles = (EQ + tile - 1) / tile;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* stages = reinterpret_cast<T*>(smem_raw);          // nbuf x (R, tile)
    T* rs = stages + (size_t)nbuf * R * tile;            // flat step: w * r_i at rs[(i * NQ + m) * nthr + t]
    T* Ad = rs;                                          // register step: A (n_eq, S), zeros included
    size_t* roff = reinterpret_cast<size_t*>(rs + (size_t)n_eq * tile);  // row r's offset
    T* ent = reinterpret_cast<T*>(roff + R);             // A's entries (ca_stage_flat)
    int* ient = reinterpret_cast<int*>(ent + 2 * ca_eqstart[n_eq] + S);

    // row r of a tile: slot r = d * c + u of G (offset from QP k's slot 0), then the
    // J^-1 planes (from ji + k), then w (from w + k)
    for (int r = tid; r < R; r += nthr) {
        const int d = r / c, u = r - d * c;
        roff[r] = r < S ? (LAT ? (size_t)r * EQ : (size_t)(u * D1 + d) * Q) : r < R - 1 ? (size_t)(r - S) * EQ : 0;
    }
    CaFlat<T> coef{};
    if constexpr (REG) {
        for (int x = tid; x < n_eq * S; x += nthr) Ad[x] = 0;
        __syncthreads();
        for (int i = tid; i < n_eq; i += nthr)
            for (int e = ca_eqstart[i]; e < ca_eqstart[i + 1]; ++e) Ad[i * S + ca_rd[e] * c + ca_ru[e]] = (T)ca_rval[e];
    } else {
        coef = ca_stage_flat(ient, ent, n_eq, c, S, c * tile, tile, NQ * nthr, tid, nthr);
    }
    __syncthreads();

    // offset of QP k's value of slot 0 in G and T
    auto gbase = [&](int k) -> size_t {
        if (LAT) return k;
        const int e = fast_div(k, qmul, qshr);
        return (size_t)e * S * Q + (k - e * Q);
    };
    // start the copies of tile t into buf (zero-filled past EQ)
    auto fetch = [&](int t, T* buf) {
        const int k0 = t * tile;
        for (int l = tid; l < R * ch; l += nthr) {
            const int r = l >> lg, j = l & (ch - 1), k = k0 + j * vq;
            const bool valid = k < EQ;
            const T* src = G;
            if (valid) src = (r < S ? G + gbase(k) : r < R - 1 ? ji + k : w + k) + roff[r];
            T* dst = buf + (size_t)r * tile + j * vq;
            if (vec)
                cp_async<16>(dst, src, valid);
            else
                cp_async<sizeof(T)>(dst, src, valid);
        }
    };

    // With three or more tiles a tile's refill starts as soon as it is in (into
    // the slot of the tile before, whose stores are done), else after its stores.
    const bool early = nbuf >= 3;
    const int ahead = early ? nbuf - 1 : nbuf;  // tiles in flight while a tile computes, at most 2
    for (int b = 0; b < ahead; ++b) {
        const int t = blockIdx.x + b * gridDim.x;
        if (t < n_tiles) fetch(t, stages + (size_t)b * R * tile);
        cp_async_commit();
    }
    for (int i = 0, t = blockIdx.x; t < n_tiles; ++i, t += gridDim.x) {
        T* buf = stages + (size_t)(i % nbuf) * R * tile;
        if (ahead == 2)
            cp_async_wait<1>();
        else
            cp_async_wait<0>();
        __syncthreads();  // the tile is in, and the tile before it is stored
        if (early) {
            const int next = t + (nbuf - 1) * gridDim.x;
            if (next < n_tiles) fetch(next, stages + (size_t)((i + nbuf - 1) % nbuf) * R * tile);
            cp_async_commit();
        }

        T J[NQ][DIM][DIM], wq[NQ];
#pragma unroll
        for (int m = 0; m < NQ; ++m) {
            const int q = tid + m * nthr;
#pragma unroll
            for (int j = 0; j < DIM; ++j)
#pragma unroll
                for (int i2 = 0; i2 < DIM; ++i2) J[m][j][i2] = buf[(size_t)(S + j * DIM + i2) * tile + q];
            wq[m] = buf[(size_t)(S + DIM * DIM) * tile + q];
        }
        if constexpr (REG)
            qp_step_registers<T, DIM, C>(buf, tid, J, wq, Ad, n_eq);
        else
            ca_qp_step_flat<T, DIM, NQ>(buf + tid, nthr, c * tile, tile, J, wq, rs + tid, nthr, c, coef);
        __syncthreads();  // the tile's results are in place

        const int k0 = t * tile;
        for (int l = tid; l < S * ch; l += nthr) {
            const int r = l >> lg, j = l & (ch - 1), k = k0 + j * vq;
            if (k >= EQ) continue;
            const T* src = buf + (size_t)r * tile + j * vq;
            T* dst = Tout + gbase(k) + roff[r];
            if (vec)
                *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            else
                *dst = *src;
        }
        if (!early) {
            __syncthreads();  // every read of buf is done before it is refilled
            const int next = t + nbuf * gridDim.x;
            if (next < n_tiles) fetch(next, buf);
            cp_async_commit();
        }
    }
}

template <typename T, int DIM, int C, bool LAT, int NQ, int NT>
static const void* kernel_ptr()
{
    return (const void*)qp_kernel<T, DIM, C, LAT, NQ, NT>;
}

// The instantiation for (dim, c, layout, tile): at the full tile, in f32, c = 1, 3, 4
// compile-time (the register step), any other c run-time; f64 always run-time (its
// registers would spill, so it takes the flat records, where a compiled c gains
// nothing).  A smaller tile (128, 64 or 32 QPs) runs the flat records, one QP a thread.
template <typename T, int DIM, bool LAT>
static const void* kernel_for_c(int c, int tile)
{
    if (tile != QP_TILE) return kernel_ptr<T, DIM, 0, LAT, 1, 0>();
    if constexpr (sizeof(T) == 4) {
        switch (c) {
            case 1: return kernel_ptr<T, DIM, 1, LAT, QP_NQ, QP_THREADS>();
            case 3: return kernel_ptr<T, DIM, 3, LAT, QP_NQ, QP_THREADS>();
            case 4: return kernel_ptr<T, DIM, 4, LAT, QP_NQ, QP_THREADS>();
        }
    }
    return kernel_ptr<T, DIM, 0, LAT, QP_NQ, QP_THREADS>();
}

// The block width of a tile (0: not a tile of the kernel).
static int threads_for(int tile)
{
    return tile == QP_TILE ? QP_THREADS : (tile == 128 || tile == 64 || tile == 32) ? tile : 0;
}

template <typename T>
static const void* kernel_for(int dim, int c, int lattice, int tile)
{
    if (threads_for(tile) == 0) return nullptr;
    if (dim == 2) return lattice ? kernel_for_c<T, 2, true>(c, tile) : kernel_for_c<T, 2, false>(c, tile);
    if (dim == 3) return lattice ? kernel_for_c<T, 3, true>(c, tile) : kernel_for_c<T, 3, false>(c, tile);
    return nullptr;
}

template <typename T>
static int launch(const T* G, const T* ji, const T* w, T* Tout, int EQ, int Q, int c, int dim, int n_eq,
                  int lattice, int vec, int nbuf, int tile, unsigned qmul, int qshr, int grid, int smem, int device,
                  void* stream)
{
    const void* fn = kernel_for<T>(dim, c, lattice, tile);
    if (fn == nullptr || nbuf < 1 || nbuf > 3) return (int)cudaErrorInvalidValue;  // at most 2 tiles in flight
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return (int)guard.status;
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {(void*)&G, (void*)&ji, (void*)&w, (void*)&Tout, &EQ, &Q, &c, &n_eq, &vec, &nbuf, &qmul, &qshr};
    e = cudaLaunchKernel(fn, dim3(grid), dim3(threads_for(tile)), args, (size_t)smem, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

CA_EXPORTS(qp)

extern "C" {

int qp_threads() { return QP_THREADS; }
int qp_tile() { return QP_TILE; }

int qp_f32(const float* G, const float* ji, const float* w, float* Tout, int EQ, int Q, int c, int dim, int n_eq,
           int lattice, int vec, int nbuf, int tile, unsigned qmul, int qshr, int grid, int smem, int device,
           void* stream)
{
    return launch<float>(G, ji, w, Tout, EQ, Q, c, dim, n_eq, lattice, vec, nbuf, tile, qmul, qshr, grid, smem,
                         device, stream);
}

int qp_f64(const double* G, const double* ji, const double* w, double* Tout, int EQ, int Q, int c, int dim,
           int n_eq, int lattice, int vec, int nbuf, int tile, unsigned qmul, int qshr, int grid, int smem,
           int device, void* stream)
{
    return launch<double>(G, ji, w, Tout, EQ, Q, c, dim, n_eq, lattice, vec, nbuf, tile, qmul, qshr, grid, smem,
                          device, stream);
}

// Resident blocks per SM of one instantiation and tile at a dynamic shared memory size
// (< 0: a CUDA error).
int qp_occupancy(int f64, int dim, int c, int lattice, int tile, int smem, int device)
{
    const void* fn = f64 ? kernel_for<double>(dim, c, lattice, tile) : kernel_for<float>(dim, c, lattice, tile);
    if (fn == nullptr) return -(int)cudaErrorInvalidValue;
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return -(int)guard.status;
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return -(int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads_for(tile), (size_t)smem);
    return e == cudaSuccess ? blocks : -(int)e;
}

// Streaming multiprocessors of the device (< 0: a CUDA error).
int qp_sm_count(int device)
{
    int n = 0;
    cudaError_t e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
