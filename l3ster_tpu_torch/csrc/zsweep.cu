// Fused z-sweep of the lattice sum-factorized LSFEM operator apply, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel l3ster_tpu/ops/pallas_zsweep2.py:fused_z_sweep_v2
// (pallas_call at :402) in all its modes, and serves its v1 predecessor
// l3ster_tpu/ops/pallas_zsweep.py:fused_z_sweep (pallas_call at :138; ops/zsweep_v1.py):
// per column q of the flattened (R, Q) plane and per z-QP s,
//   v, dz  = Nz^T b, Dz^T b;  dy = Nz^T bdy;  dx = Nz^T bdx        (z interpolation)
//   g      = (v, J^-T (dx, dy, dz))                                (diag or full 9-plane J^-1)
//   r_i    = w * sum_{d,u} A[d,i,u] g[d,u];  t[d,u] = sum_i A[d,i,u] r_i
//   t_ref  = J^-1 (t1, t2, t3)
//   a = Nz t0 + Dz tz;  ady = Nz ty;  adx = Nz tx                  (z transpose)
// with a, ady, adx written back in the input layout: "cz" (c, n1z, RQ) or "zc"
// (n1z, c, RQ), given to the kernel as the channel and z strides of the tensors.
// A is constant (its nonzeros in __constant__ memory) or variable: VAR streams the
// nonzero (d, i, u) planes A_nz (K, S, RQ) from device memory, one value per QP and
// entry, through the same by-equation table with plane numbers in place of values.
//
// What bounds it on this card: bytes.  The six b/a tensors, the geometry and in VAR
// mode the K planes of A_nz are the only large traffic (444 MB at the var 12^3 shape
// in f32: 0.13 ms at 3.35 TB/s); the arithmetic of the nonzero table bands and the
// per-QP algebra is a few GFLOP.  The design:
// - Element layers.  A lattice z table is ne_z layers of nq QP rows over nn node rows,
//   neighbouring layers sharing one node row.  The host finds the layers
//   (ops/zsweep.py:zsweep_tables) and hands over only each layer's dense (nq, nn)
//   N and D blocks (a few KB) in place of the (n1z, S) tables, 95% zeros at 12^3.
// - A block owns 32 columns (one warp along the column axis, so every load and store
//   of b, a, A_nz and J^-1 is a whole 128-byte line) and a chunk of layers, walked in
//   order.  Shared memory holds one layer at a time: its node rows (double-buffered,
//   the next layer's arriving by cp.async while this one computes, issued after the
//   barrier that ends every read of the buffer it fills) and its (4c, nq)
//   QP tile; chunks split z across blocks where the columns alone would not fill the
//   card (the bench: 162 column tiles).
// - Phase 1, a thread per (column, QP row): z interpolation, J^-T, the algebra, J^-1,
//   in place in the QP tile.  A's nonzero entries are copied once per block into
//   shared memory as (offset, coefficient) pairs, and in VAR mode the layer's K
//   planes arrive by cp.async with its node rows, so the per-entry loops read
//   shared memory only.  (Per-QP sums in registers would need compile-time slot
//   indices, and walking A's run-time entries against them is a chain of dependent
//   __constant__ and plane loads: latency-bound, 0.95 ms at 12^3 on the H100.)
// - Phase 2, a thread per (column, output tensor, channel): the z transpose of the
//   layer into its nn node rows held in registers.  The node row shared with the
//   next layer is carried in shared memory to the next iteration; at a chunk edge
//   both blocks add their part with atomicAdd onto a row zeroed before the launch (two
//   adds onto zero give the same bits in either order, so the result is deterministic).
//   A layer of at most ZS_MAXN node rows (order <= 7) keeps its table entries and
//   transpose sums in registers; a wider one, in its own instantiation, reads them
//   from shared memory, so any element order runs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (l3ster_tpu_torch/ops/zsweep.py builds and loads it with ctypes).

#include "async_copy.cuh"
#include "const_coeffs.cuh"

#define ZS_MAXY 12   // threads along the QP rows of a layer
#define ZS_MAXN 8    // node rows of a layer held in registers (wider layers take a slower loop)
#define ZS_THREADS (32 * ZS_MAXY)

template <typename T>
struct ZsArgs {
    const T *b, *bdy, *bdx;          // (u, z, q) at u * cs + z * zs + q
    const T *g0, *g1, *g2, *g3, *g4; // DIAG: jx (RQ), jy (RQ), jz (S), wyx (RQ), wz (S)
                                     // full: ji (9, S, RQ), plane j*3+i = Ji[j, i]; w (S, RQ)
    const T* Anz;                    // VAR: (K, S, RQ)
    const T* blk;                    // (2, nL, WQ, WN): each layer's N block, then D block
    const int* lay;                  // (nL, 4): s0, nq, z0, nn of each layer
    T *a, *ady, *adx;
    int c, S, RQ, n_eq, nL, WQ, WN, CL, cs, zs, K, n_ent;
};

// WIDE: layers of more than ZS_MAXN node rows (order >= ZS_MAXN), their own instantiation
// so that the narrow layers' register path keeps its registers
template <typename T, bool DIAG, bool VAR, bool WIDE>
__global__ void __launch_bounds__(ZS_THREADS, 2) zsweep_kernel(const ZsArgs<T> p)
{
    const int c = p.c, K = VAR ? p.K : 0, n_ent = p.n_ent;
    const int TQ = blockDim.x, tq = threadIdx.x, tyi = threadIdx.y, BY = blockDim.y;
    const int tid = tyi * TQ + tq, nthr = TQ * BY;
    const int q = blockIdx.x * TQ + tq;
    const bool live = q < p.RQ;
    const int nL = p.nL, WQ = p.WQ, WN = p.WN;
    const int L0 = blockIdx.y * p.CL, L1 = min(nL, L0 + p.CL);
    const size_t ks = (size_t)p.S * p.RQ;  // plane stride of ji and A_nz
    const int SL = WQ * TQ;                // slot stride of the QP, r and plane tiles
    const int NT = 3 * c * WN * TQ;        // the node rows of a layer buffer
    const int LB = NT + 2 * WQ * WN + K * SL;  // one layer buffer
    const int* __restrict__ lay = p.lay;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* buf = reinterpret_cast<T*>(smem_raw);  // 2 layer buffers: node rows (3, c, WN, TQ),
                                              // N and D blocks (2, WQ, WN), planes (K, WQ, TQ)
    T* QT = buf + 2 * LB;                     // (4c, WQ, TQ): g, then t in place
    T* R = QT + 4 * c * SL;                   // (n_eq, WQ, TQ): w * r
    T* carry = R + p.n_eq * SL;               // (3c, TQ): the shared node row's partial sums
    T* vr = carry + 3 * c * TQ;               // (n_ent,) coefficient of entry e, by equation
    T* vt = vr + n_ent;                       // (n_ent,) ... by slot
    int* gofs = reinterpret_cast<int*>(vt + n_ent);  // QT offset of entry e's g slot
    int* rofs = gofs + n_ent;                 // R offset of entry e's equation (by slot)
    int* pr = rofs + n_ent;                   // VAR: plane tile offset of entry e, by equation
    int* pt = pr + n_ent;                     // ... by slot

    // node rows, tables and planes of layer L into its buffer
    auto prefetch = [&](int L, T* lb) {
        const int s0 = __ldg(lay + 4 * L), nq = __ldg(lay + 4 * L + 1);
        const int z0 = __ldg(lay + 4 * L + 2), nn = __ldg(lay + 4 * L + 3);
        const size_t qq = live ? q : 0;
        for (int r = tyi; r < 3 * c * nn; r += BY) {
            const int m = r / (c * nn), rem = r - m * c * nn;
            const int u = rem / nn, i = rem - u * nn;
            const T* src = (m == 0 ? p.b : m == 1 ? p.bdy : p.bdx) + (size_t)u * p.cs + (size_t)(z0 + i) * p.zs + qq;
            cp_async<sizeof(T)>(lb + ((m * c + u) * WN + i) * TQ + tq, src, live);
        }
        for (int k = tid; k < 2 * WQ * WN; k += nthr) {
            const int h = k / (WQ * WN);
            cp_async<sizeof(T)>(lb + NT + k, p.blk + ((size_t)h * nL + L) * WQ * WN + (k - h * WQ * WN), true);
        }
        if (VAR)
            for (int r = tyi; r < K * nq; r += BY) {
                const int k = r / nq, sy = r - k * nq;
                cp_async<sizeof(T)>(lb + NT + 2 * WQ * WN + k * SL + sy * TQ + tq,
                                    p.Anz + (size_t)k * ks + (size_t)(s0 + sy) * p.RQ + qq, live);
            }
        cp_async_commit();
    };

    prefetch(L0, buf);
    // A's entries with their shared-memory offsets, so the algebra reads no __constant__
    // table in its inner loops (const_coeffs.cuh keeps them by equation and by slot)
    for (int e = tid; e < n_ent; e += nthr) {
        gofs[e] = (ca_rd[e] * c + ca_ru[e]) * SL;
        rofs[e] = ca_teq[e] * SL;
        if (VAR) {
            pr[e] = ((int)ca_rval[e] - 1) * SL;
            pt[e] = ((int)ca_tval[e] - 1) * SL;
        } else {
            vr[e] = (T)ca_rval[e];
            vt[e] = (T)ca_tval[e];
        }
    }
    T jx = 0, jy = 0, wyx = 0;
    if (DIAG && live) {
        jx = p.g0[q];
        jy = p.g1[q];
        wyx = p.g3[q];
    }

    for (int L = L0; L < L1; ++L) {
        const T* lb = buf + ((L - L0) & 1) * LB;
        cp_async_wait<0>();
        __syncthreads();  // layer L is in; layer L - 1's buffer and QP tile are read in full
        if (L + 1 < L1) prefetch(L + 1, buf + ((L + 1 - L0) & 1) * LB);  // overlaps layer L
        const int s0 = __ldg(lay + 4 * L), nq = __ldg(lay + 4 * L + 1);
        const int z0 = __ldg(lay + 4 * L + 2), nn = __ldg(lay + 4 * L + 3);
        const T* tN = lb + NT;
        const T* tD = tN + WQ * WN;
        const T* pl = tD + WQ * WN;

        // ---- phase 1: z interpolation + per-QP least-squares algebra, in place in the QP tile
        for (int sy = tyi; live && sy < nq; sy += BY) {
            const int s = s0 + sy;
            const size_t sq = (size_t)s * p.RQ + q;
            T J[9], jz = 0, w;
            if (DIAG) {
                jz = p.g2[s];
                w = p.g4[s] * wyx;
            } else {
#pragma unroll
                for (int k = 0; k < 9; ++k) J[k] = p.g0[k * ks + sq];
                w = p.g1[sq];
            }
            T nr[ZS_MAXN], dr[ZS_MAXN];  // the QP row's table entries (narrow layers)
            if constexpr (!WIDE) {
#pragma unroll
                for (int i = 0; i < ZS_MAXN; ++i) {
                    nr[i] = i < nn ? tN[sy * WN + i] : T(0);
                    dr[i] = i < nn ? tD[sy * WN + i] : T(0);
                }
            }
            T* gp = QT + sy * TQ + tq;  // slot k at gp[k * SL]
            T* rp = R + sy * TQ + tq;
            const T* pq = pl + sy * TQ + tq;
            for (int u = 0; u < c; ++u) {
                const T* n0 = lb + u * WN * TQ + tq;
                const T* n1 = n0 + c * WN * TQ;
                const T* n2 = n1 + c * WN * TQ;
                T v = 0, dz = 0, dy = 0, dx = 0;
                if constexpr (!WIDE) {
#pragma unroll
                    for (int i = 0; i < ZS_MAXN; ++i) {
                        if (i < nn) {
                            const T bb = n0[i * TQ];
                            v += nr[i] * bb;
                            dz += dr[i] * bb;
                            dy += nr[i] * n1[i * TQ];
                            dx += nr[i] * n2[i * TQ];
                        }
                    }
                } else {  // the entries from shared memory
                    for (int i = 0; i < nn; ++i) {
                        const T bb = n0[i * TQ], ni = tN[sy * WN + i];
                        v += ni * bb;
                        dz += tD[sy * WN + i] * bb;
                        dy += ni * n1[i * TQ];
                        dx += ni * n2[i * TQ];
                    }
                }
                gp[u * SL] = v;
                if (DIAG) {
                    gp[(c + u) * SL] = jx * dx;
                    gp[(2 * c + u) * SL] = jy * dy;
                    gp[(3 * c + u) * SL] = jz * dz;
                } else {
                    gp[(c + u) * SL] = J[0] * dx + J[3] * dy + J[6] * dz;
                    gp[(2 * c + u) * SL] = J[1] * dx + J[4] * dy + J[7] * dz;
                    gp[(3 * c + u) * SL] = J[2] * dx + J[5] * dy + J[8] * dz;
                }
            }
            for (int i = 0; i < p.n_eq; ++i) {
                T r = 0;
                for (int e = ca_eqstart[i]; e < ca_eqstart[i + 1]; ++e)
                    r += (VAR ? pq[pr[e]] : vr[e]) * gp[gofs[e]];
                rp[i * SL] = r * w;
            }
            for (int sl = 0; sl < 4 * c; ++sl) {
                T tt = 0;
                for (int e = ca_slotstart[sl]; e < ca_slotstart[sl + 1]; ++e)
                    tt += (VAR ? pq[pt[e]] : vt[e]) * rp[rofs[e]];
                gp[sl * SL] = tt;
            }
            for (int u = 0; u < c; ++u) {  // t_ref = J^-1 (t1, t2, t3)
                const T t1 = gp[(c + u) * SL], t2 = gp[(2 * c + u) * SL], t3 = gp[(3 * c + u) * SL];
                if (DIAG) {
                    gp[(c + u) * SL] = jx * t1;
                    gp[(2 * c + u) * SL] = jy * t2;
                    gp[(3 * c + u) * SL] = jz * t3;
                } else {
                    gp[(c + u) * SL] = J[0] * t1 + J[1] * t2 + J[2] * t3;
                    gp[(2 * c + u) * SL] = J[3] * t1 + J[4] * t2 + J[5] * t3;
                    gp[(3 * c + u) * SL] = J[6] * t1 + J[7] * t2 + J[8] * t3;
                }
            }
        }
        __syncthreads();  // the QP tile is complete; layer L's buffer is read

        // ---- phase 2: z transpose of the layer; a thread per (column, tensor m, channel u)
        for (int kk = tyi; live && kk < 3 * c; kk += BY) {
            const int m = kk / c, u = kk - m * c;  // m: 0 -> a, 1 -> ady, 2 -> adx
            const T* t1 = QT + ((m == 0 ? 0 : 3 - m) * c + u) * SL + tq;  // t0, ty or tx
            const T* t3 = QT + (3 * c + u) * SL + tq;                      // tz (a only)
            T* out = m == 0 ? p.a : m == 1 ? p.ady : p.adx;
            T* cr = carry + kk * TQ + tq;
            auto emit = [&](int i, T val) {  // node row i of the layer
                T* o = out + (size_t)u * p.cs + (size_t)(z0 + i) * p.zs + q;
                if (i == 0 && L > 0) {  // shared with layer L - 1
                    if (L == L0) {
                        atomicAdd(o, val);
                        return;
                    }
                    val += *cr;
                }
                if (i == nn - 1 && L + 1 < nL) {  // shared with layer L + 1
                    if (L + 1 == L1)
                        atomicAdd(o, val);
                    else
                        *cr = val;
                    return;
                }
                *o = val;
            };
            if constexpr (!WIDE) {
                T acc[ZS_MAXN];
#pragma unroll
                for (int i = 0; i < ZS_MAXN; ++i) acc[i] = 0;
                for (int sy = 0; sy < nq; ++sy) {
                    const T v1 = t1[sy * TQ];
                    const T* nrow = tN + sy * WN;
                    if (m == 0) {
                        const T v3 = t3[sy * TQ];
                        const T* drow = tD + sy * WN;
#pragma unroll
                        for (int i = 0; i < ZS_MAXN; ++i)
                            if (i < nn) acc[i] += nrow[i] * v1 + drow[i] * v3;
                    } else {
#pragma unroll
                        for (int i = 0; i < ZS_MAXN; ++i)
                            if (i < nn) acc[i] += nrow[i] * v1;
                    }
                }
#pragma unroll
                for (int i = 0; i < ZS_MAXN; ++i)
                    if (i < nn) emit(i, acc[i]);
            } else {  // one node row at a time, the QP tile read per row
                for (int i = 0; i < nn; ++i) {
                    T acc = 0;
                    for (int sy = 0; sy < nq; ++sy)
                        acc += tN[sy * WN + i] * t1[sy * TQ] + (m == 0 ? tD[sy * WN + i] * t3[sy * TQ] : T(0));
                    emit(i, acc);
                }
            }
        }
    }
}

template <typename T, bool WIDE>
static const void* kernel_for(int diag, int var)
{
    if (diag && var) return (const void*)zsweep_kernel<T, true, true, WIDE>;
    if (diag) return (const void*)zsweep_kernel<T, true, false, WIDE>;
    if (var) return (const void*)zsweep_kernel<T, false, true, WIDE>;
    return (const void*)zsweep_kernel<T, false, false, WIDE>;
}

// the instantiation for layers of at most WN node rows
template <typename T>
static const void* kernel_for(int diag, int var, int WN)
{
    return WN > ZS_MAXN ? kernel_for<T, true>(diag, var) : kernel_for<T, false>(diag, var);
}

template <typename T>
static int launch(const void* const* ptr, const int* n, int device, void* stream)
{
    // n: c, S, RQ, n_eq, nL, WQ, WN, CL, cs, zs, K, n_ent, diag, var, tq, by, chunks, smem,
    // and the rows two chunks share: (width, pitch, height) of one edge's block of rows
    ZsArgs<T> p{(const T*)ptr[0], (const T*)ptr[1], (const T*)ptr[2], (const T*)ptr[3],
                (const T*)ptr[4], (const T*)ptr[5], (const T*)ptr[6], (const T*)ptr[7],
                (const T*)ptr[8], (const T*)ptr[9], (const int*)ptr[10], (T*)ptr[11],
                (T*)ptr[12], (T*)ptr[13], n[0], n[1], n[2], n[3], n[4], n[5], n[6], n[7],
                n[8], n[9], n[10], n[11]};
    const int tq = n[14], by = n[15], smem = n[17];
    if (tq * by > ZS_THREADS || (n[16] > 1 && ptr[14] == nullptr)) return (int)cudaErrorInvalidValue;
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return (int)guard.status;
    const void* fn = kernel_for<T>(n[12], n[13], n[6]);
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    // both chunks' parts of a shared node row are added onto zero: zero the node row
    // z = edges[j] of all three outputs (a, ady, adx contiguous from ptr[11])
    const int* edges = (const int*)ptr[14];
    for (int j = 0; j + 1 < n[16]; ++j) {
        e = cudaMemset2DAsync(p.a + (size_t)edges[j] * p.zs, (size_t)n[19] * sizeof(T), 0,
                              (size_t)n[18] * sizeof(T), n[20], (cudaStream_t)stream);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((n[2] + tq - 1) / tq, n[16]), block(tq, by);
    void* args[] = {&p};
    e = cudaLaunchKernel(fn, grid, block, args, (size_t)smem, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

CA_EXPORTS(zsweep)

extern "C" {

// ptr: b, bdy, bdx, g0..g4, Anz, blk, lay, a, ady, adx, and on the host the node row of
// each chunk edge (chunks - 1 ints); n: see launch()
int zsweep_f32(const void* const* ptr, const int* n, int device, void* stream)
{
    return launch<float>(ptr, n, device, stream);
}

int zsweep_f64(const void* const* ptr, const int* n, int device, void* stream)
{
    return launch<double>(ptr, n, device, stream);
}

// Resident blocks per SM of one instantiation (layers of at most WN node rows) at a
// launch shape (< 0: a CUDA error).
int zsweep_occupancy(int f64, int diag, int var, int WN, int threads, int smem, int device)
{
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return -(int)guard.status;
    const void* fn = f64 ? kernel_for<double>(diag, var, WN) : kernel_for<float>(diag, var, WN);
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return -(int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, (size_t)smem);
    return e == cudaSuccess ? blocks : -(int)e;
}

}  // extern "C"
