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
// What bounds it on this card: the six b/a tensors (and in VAR mode the K planes of
// A_nz) are the only large traffic (about 18 MB at the p=6 6^3-hex bench in f32, plus
// 22 MB of A_nz at K = 15); the z tables are block-banded, so the contractions need
// about p+1 nonzero z rows per QP plane, which puts the arithmetic (~0.2 GFLOP) under
// the byte bound.  The design keeps every QP-space intermediate out of device memory:
// phase 1 writes the (t0, tx, ty, tz) tile of a block's columns to shared memory,
// phase 2 runs the z transpose from it, and only the band of each table row is
// visited.  One block per tile of TQ columns; the z tables and their band limits are
// staged in shared memory; the entries of A live in __constant__ memory
// (const_coeffs.cuh, by-equation table), so zero coefficients cost nothing.  A
// variable plane value is read twice per QP (for r and for t), the second time from
// L1.  This is the simple correct design: it runs one block per SM at the bench and
// is latency-bound, not yet near the byte bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (l3ster_tpu_torch/ops/zsweep.py builds and loads it with ctypes).

#include "const_coeffs.cuh"

#define ZS_THREADS 256

// Entry e of the by-equation table at the QP at offset sq of an (S, RQ) plane.
template <typename T, bool VAR>
__device__ __forceinline__ T zs_coef(int e, const T* __restrict__ Anz, size_t ks, size_t sq)
{
    if (VAR) return Anz[(size_t)((int)ca_rval[e] - 1) * ks + sq];
    return (T)ca_rval[e];
}

template <typename T, bool DIAG, bool VAR>
__global__ void __launch_bounds__(ZS_THREADS) zsweep_kernel(
    const T* __restrict__ b, const T* __restrict__ bdy, const T* __restrict__ bdx,
    const T* __restrict__ g0, const T* __restrict__ g1, const T* __restrict__ g2,
    const T* __restrict__ g3, const T* __restrict__ g4, const T* __restrict__ Anz,
    const T* __restrict__ NzT, const T* __restrict__ DzT, const int* __restrict__ band,
    T* __restrict__ a, T* __restrict__ ady, T* __restrict__ adx,
    int c, int n1z, int S, int RQ, int n_eq, int TQ, int cs, int zs)
{
    // geometry: DIAG -> g0 = jx (RQ), g1 = jy (RQ), g2 = jz (S), g3 = wyx (RQ), g4 = wz (S)
    //           full -> g0 = ji (9, S, RQ) with plane k = j*3 + i holding Ji[j, i], g1 = w (S, RQ)
    // b, bdy, bdx, a, ady, adx: element (u, z, q) at u * cs + z * zs + q
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* tabN = reinterpret_cast<T*>(smem_raw);   // (n1z, S)
    T* tabD = tabN + n1z * S;                    // (n1z, S)
    const int SQ = S * TQ;
    T* G = tabD + n1z * S;                       // (4c, S, TQ): g, then (t0, tx, ty, tz)
    T* Tacc = G + 4 * c * SQ;                    // (4c, S, TQ): t accumulators
    int* zlo = reinterpret_cast<int*>(Tacc + 4 * c * SQ);
    int* zhi = zlo + S;                          // nonzero z rows of table column s
    int* slo = zhi + S;
    int* shi = slo + n1z;                        // nonzero s columns of table row z

    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthr = blockDim.x * blockDim.y;
    for (int k = tid; k < n1z * S; k += nthr) {
        tabN[k] = NzT[k];
        tabD[k] = DzT[k];
    }
    for (int k = tid; k < 2 * S + 2 * n1z; k += nthr) zlo[k] = band[k];
    __syncthreads();

    const int tq = threadIdx.x;
    const int q = blockIdx.x * TQ + tq;
    const bool live = q < RQ;
    const size_t ks = (size_t)S * RQ;  // plane stride of ji and A_nz

    // ---- phase 1: z interpolation + per-QP least-squares algebra into shared memory
    if (live) {
        for (int s = threadIdx.y; s < S; s += blockDim.y) {
            const int z0 = zlo[s], z1 = zhi[s];
            const int base = s * TQ + tq;
            const size_t sq = (size_t)s * RQ + q;
            const T* ji = DIAG ? nullptr : g0 + sq;
            T jx = 0, jy = 0, jz = 0;
            if (DIAG) {
                jx = g0[q];
                jy = g1[q];
                jz = g2[s];
            }
            for (int u = 0; u < c; ++u) {
                const T* bu = b + (size_t)u * cs + q;
                const T* byu = bdy + (size_t)u * cs + q;
                const T* bxu = bdx + (size_t)u * cs + q;
                T v = 0, dz = 0, dy = 0, dx = 0;
                for (int z = z0; z <= z1; ++z) {
                    const T n = tabN[z * S + s];
                    const T d = tabD[z * S + s];
                    const size_t o = (size_t)z * zs;
                    const T bb = bu[o];
                    v += n * bb;
                    dz += d * bb;
                    dy += n * byu[o];
                    dx += n * bxu[o];
                }
                T px, py, pz;
                if (DIAG) {
                    px = jx * dx;
                    py = jy * dy;
                    pz = jz * dz;
                } else {
                    px = ji[0 * ks] * dx + ji[3 * ks] * dy + ji[6 * ks] * dz;
                    py = ji[1 * ks] * dx + ji[4 * ks] * dy + ji[7 * ks] * dz;
                    pz = ji[2 * ks] * dx + ji[5 * ks] * dy + ji[8 * ks] * dz;
                }
                G[(0 * c + u) * SQ + base] = v;
                G[(1 * c + u) * SQ + base] = px;
                G[(2 * c + u) * SQ + base] = py;
                G[(3 * c + u) * SQ + base] = pz;
                for (int d = 0; d < 4; ++d) Tacc[(d * c + u) * SQ + base] = 0;
            }
            const T w = DIAG ? g4[s] * g3[q] : g1[sq];
            for (int i = 0; i < n_eq; ++i) {
                const int e0 = ca_eqstart[i], e1 = ca_eqstart[i + 1];
                if (e0 == e1) continue;
                T r = 0;
                for (int e = e0; e < e1; ++e)
                    r += zs_coef<T, VAR>(e, Anz, ks, sq) * G[(ca_rd[e] * c + ca_ru[e]) * SQ + base];
                r *= w;
                for (int e = e0; e < e1; ++e)
                    Tacc[(ca_rd[e] * c + ca_ru[e]) * SQ + base] += zs_coef<T, VAR>(e, Anz, ks, sq) * r;
            }
            for (int u = 0; u < c; ++u) {
                const T t0 = Tacc[(0 * c + u) * SQ + base];
                const T t1 = Tacc[(1 * c + u) * SQ + base];
                const T t2 = Tacc[(2 * c + u) * SQ + base];
                const T t3 = Tacc[(3 * c + u) * SQ + base];
                T tx, ty, tz;
                if (DIAG) {
                    tx = jx * t1;
                    ty = jy * t2;
                    tz = jz * t3;
                } else {
                    tx = ji[0 * ks] * t1 + ji[1 * ks] * t2 + ji[2 * ks] * t3;
                    ty = ji[3 * ks] * t1 + ji[4 * ks] * t2 + ji[5 * ks] * t3;
                    tz = ji[6 * ks] * t1 + ji[7 * ks] * t2 + ji[8 * ks] * t3;
                }
                G[(0 * c + u) * SQ + base] = t0;
                G[(1 * c + u) * SQ + base] = tx;
                G[(2 * c + u) * SQ + base] = ty;
                G[(3 * c + u) * SQ + base] = tz;
            }
        }
    }
    __syncthreads();

    // ---- phase 2: z transpose from the shared (t0, tx, ty, tz) tile
    if (live) {
        for (int z = threadIdx.y; z < n1z; z += blockDim.y) {
            const int s0 = slo[z], s1 = shi[z];
            for (int u = 0; u < c; ++u) {
                T av = 0, ay = 0, ax = 0;
                for (int s = s0; s <= s1; ++s) {
                    const T n = tabN[z * S + s];
                    const T d = tabD[z * S + s];
                    const int base = s * TQ + tq;
                    av += n * G[(0 * c + u) * SQ + base] + d * G[(3 * c + u) * SQ + base];
                    ay += n * G[(2 * c + u) * SQ + base];
                    ax += n * G[(1 * c + u) * SQ + base];
                }
                const size_t o = (size_t)u * cs + (size_t)z * zs + q;
                a[o] = av;
                ady[o] = ay;
                adx[o] = ax;
            }
        }
    }
}

template <typename T, bool DIAG, bool VAR>
static int launch(const T* b, const T* bdy, const T* bdx, const T* g0, const T* g1,
                  const T* g2, const T* g3, const T* g4, const T* Anz, const T* NzT,
                  const T* DzT, const int* band, T* a, T* ady, T* adx, int c, int n1z, int S,
                  int RQ, int n_eq, int tq, int smem, int cs, int zs, int device, void* stream)
{
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return (int)guard.status;
    cudaError_t e = cudaFuncSetAttribute(zsweep_kernel<T, DIAG, VAR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 block(tq, ZS_THREADS / tq);
    dim3 grid((RQ + tq - 1) / tq);
    zsweep_kernel<T, DIAG, VAR><<<grid, block, smem, (cudaStream_t)stream>>>(
        b, bdy, bdx, g0, g1, g2, g3, g4, Anz, NzT, DzT, band, a, ady, adx, c, n1z, S, RQ,
        n_eq, tq, cs, zs);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const T* b, const T* bdy, const T* bdx, const T* g0, const T* g1,
                    const T* g2, const T* g3, const T* g4, const T* Anz, const T* NzT,
                    const T* DzT, const int* band, T* a, T* ady, T* adx, int c, int n1z, int S,
                    int RQ, int n_eq, int diag, int var, int tq, int smem, int cs, int zs,
                    int device, void* stream)
{
    if (diag && var)
        return launch<T, true, true>(b, bdy, bdx, g0, g1, g2, g3, g4, Anz, NzT, DzT, band, a, ady,
                                     adx, c, n1z, S, RQ, n_eq, tq, smem, cs, zs, device, stream);
    if (diag)
        return launch<T, true, false>(b, bdy, bdx, g0, g1, g2, g3, g4, Anz, NzT, DzT, band, a, ady,
                                      adx, c, n1z, S, RQ, n_eq, tq, smem, cs, zs, device, stream);
    if (var)
        return launch<T, false, true>(b, bdy, bdx, g0, g1, g2, g3, g4, Anz, NzT, DzT, band, a, ady,
                                      adx, c, n1z, S, RQ, n_eq, tq, smem, cs, zs, device, stream);
    return launch<T, false, false>(b, bdy, bdx, g0, g1, g2, g3, g4, Anz, NzT, DzT, band, a, ady,
                                   adx, c, n1z, S, RQ, n_eq, tq, smem, cs, zs, device, stream);
}

CA_EXPORTS(zsweep)

extern "C" {

int zsweep_f32(const float* b, const float* bdy, const float* bdx, const float* g0,
               const float* g1, const float* g2, const float* g3, const float* g4,
               const float* Anz, const float* NzT, const float* DzT, const int* band, float* a,
               float* ady, float* adx, int c, int n1z, int S, int RQ, int n_eq, int diag, int var,
               int tq, int smem, int cs, int zs, int device, void* stream)
{
    return dispatch<float>(b, bdy, bdx, g0, g1, g2, g3, g4, Anz, NzT, DzT, band, a, ady, adx, c,
                           n1z, S, RQ, n_eq, diag, var, tq, smem, cs, zs, device, stream);
}

int zsweep_f64(const double* b, const double* bdy, const double* bdx, const double* g0,
               const double* g1, const double* g2, const double* g3, const double* g4,
               const double* Anz, const double* NzT, const double* DzT, const int* band,
               double* a, double* ady, double* adx, int c, int n1z, int S, int RQ, int n_eq,
               int diag, int var, int tq, int smem, int cs, int zs, int device, void* stream)
{
    return dispatch<double>(b, bdy, bdx, g0, g1, g2, g3, g4, Anz, NzT, DzT, band, a, ady, adx,
                            c, n1z, S, RQ, n_eq, diag, var, tq, smem, cs, zs, device, stream);
}

}  // extern "C"
