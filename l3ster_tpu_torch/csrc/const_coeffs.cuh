// A constant coefficient matrix A (d1, n_eq, c) in __constant__ memory, shared by the
// per-QP least-squares kernels (zsweep.cu, qp_algebra.cu, sumfact_fused.cu), and the
// per-QP step of qp_algebra.cu and sumfact_fused.cu.  Each library that includes this
// header has its own copy of the arrays.
//
// Only the nonzero entries are stored, twice (l3ster_tpu_torch/ops/_cuda.py packs them):
//   by equation i, for r_i = sum_e rval[e] * g[rd[e], ru[e]], e in [eqstart[i], eqstart[i+1]);
//   by slot s = d * c + u, for t[s] = sum_e tval[e] * r[teq[e]], e in [slotstart[s], slotstart[s+1]).
// Every thread of a warp reads the same entry at the same time (a broadcast), and zero
// coefficients cost nothing, as in the TPU kernels that bake A into the instruction stream.
// In the variable-coefficient mode of zsweep.cu the tables keep the same (d, i, u) structure
// and each entry holds k + 1 in place of the value, k being the index of the entry's plane
// in the streamed A_nz (K, S, RQ) (ops/zsweep.py:plane_table).

#pragma once

#include <cuda_runtime.h>

#include "device_guard.cuh"

#define CA_MAX_ENT 2048
#define CA_MAX_EQ 64
#define CA_MAX_SLOT 256

__constant__ int ca_eqstart[CA_MAX_EQ + 1];
__constant__ int ca_rd[CA_MAX_ENT];
__constant__ int ca_ru[CA_MAX_ENT];
__constant__ double ca_rval[CA_MAX_ENT];
__constant__ int ca_slotstart[CA_MAX_SLOT + 1];
__constant__ int ca_teq[CA_MAX_ENT];
__constant__ double ca_tval[CA_MAX_ENT];

// A's entries copied by a block into shared memory as two flat record lists with the
// offsets of its own layout (ca_stage_flat), for ca_qp_step_flat: one pass over each
// list, with no per-equation or per-slot loop heads and no __constant__ reads.
//   by equation (n_ent records): r += v * g[goff]; at an equation's last entry
//     rs[rout] = w * r and r restarts (rout < 0 elsewhere);
//   by slot (n_ent + empty slots): t += v * rs[rin] (rin < 0: an empty slot's record);
//     at a slot's last record g[gout] = t and t restarts.
template <typename T>
struct CaFlat {
    const int *goff, *rout, *rin, *gout;
    const T *vr, *vt;
    int nr, nt;  // records of the two lists
};

// Records of the by-slot list for (dim+1) * c slots: entries plus one per empty slot.
__device__ __forceinline__ int ca_flat_slots(int n_slot)
{
    int n = 0;
    for (int s = 0; s < n_slot; ++s) n += max(ca_slotstart[s + 1] - ca_slotstart[s], 1);
    return n;
}

// Fill the records for QP values at g[d * ds + u * us] (d < n_slot / c) and w * r_i at
// rs[i * rstride]; ints holds 4 * n_ent + 2 * n_slot values and vals 2 * n_ent + n_slot.
// The caller syncs before reading them.
template <typename T>
__device__ __forceinline__ CaFlat<T> ca_stage_flat(int* ints, T* vals, int n_eq, int c, int n_slot, int ds,
                                                   int us, int rstride, int tid, int nthr)
{
    const int n_ent = ca_eqstart[n_eq], nt = ca_flat_slots(n_slot);
    CaFlat<T> f{ints, ints + n_ent, ints + 2 * n_ent, ints + 2 * n_ent + nt, vals, vals + n_ent, n_ent, nt};
    int* goff = ints;
    int* rout = ints + n_ent;
    int* rin = ints + 2 * n_ent;
    int* gout = rin + nt;
    T* vr = vals;
    T* vt = vals + n_ent;
    for (int i = tid; i < n_eq; i += nthr)
        for (int e = ca_eqstart[i]; e < ca_eqstart[i + 1]; ++e) {
            goff[e] = ca_rd[e] * ds + ca_ru[e] * us;
            vr[e] = (T)ca_rval[e];
            rout[e] = e + 1 == ca_eqstart[i + 1] ? i * rstride : -1;
        }
    for (int s = tid; s < n_slot; s += nthr) {
        int k = ca_slotstart[s];
        for (int s2 = 0; s2 < s; ++s2) k += ca_slotstart[s2 + 1] == ca_slotstart[s2];  // empty slots before s
        const int e0 = ca_slotstart[s], e1 = ca_slotstart[s + 1], off = (s / c) * ds + (s % c) * us;
        if (e0 == e1) {
            rin[k] = -1;
            vt[k] = 0;
            gout[k] = off;
        }
        for (int e = e0; e < e1; ++e, ++k) {
            rin[k] = ca_teq[e] * rstride;
            vt[k] = (T)ca_tval[e];
            gout[k] = e + 1 == e1 ? off : -1;
        }
    }
    return f;
}

// t[s] of one QP: the A^T half of the algebra, from r_i held at rs[i * stride].
template <typename T>
__device__ __forceinline__ T ca_tslot(int s, const T* rs, int stride)
{
    T t = 0;
    for (int e = ca_slotstart[s]; e < ca_slotstart[s + 1]; ++e) t += (T)ca_tval[e] * rs[ca_teq[e] * stride];
    return t;
}

// g_phys = (g_0, J^-T g_ref) in place, per unknown.
template <typename T, int DIM>
__device__ __forceinline__ void ca_jt(T* g, int ds, int us, const T (&J)[DIM][DIM], int c)
{
    for (int u = 0; u < c; ++u) {
        T* gu = g + u * us;
        T rd[DIM];
#pragma unroll
        for (int j = 0; j < DIM; ++j) rd[j] = gu[(1 + j) * ds];
#pragma unroll
        for (int i = 0; i < DIM; ++i) {
            T s = 0;
#pragma unroll
            for (int j = 0; j < DIM; ++j) s += J[j][i] * rd[j];
            gu[(1 + i) * ds] = s;
        }
    }
}

// The per-QP least-squares step with the constant A, in place at one QP whose values sit
// at g[d * ds + u * us] (d = 0..DIM, u = 0..c-1).  In: the value g_0 and the reference
// derivatives g_ref.  Out: (t_0, J^-1 (t_1..t_DIM)), where
//   g_phys = (g_0, J^-T g_ref),  r_i = w * sum_{d,u} A[d,i,u] g_phys[d,u],  t[d,u] = sum_i A[d,i,u] r_i.
// J[j][i] = Jinv[j, i]; w * r_i is kept at rs[i * rstride].
template <typename T, int DIM>
__device__ __forceinline__ void ca_qp_step(T* g, int ds, int us, const T (&J)[DIM][DIM], T w,
                                           T* rs, int rstride, int c, int n_eq)
{
    ca_jt<T, DIM>(g, ds, us, J, c);
    for (int i = 0; i < n_eq; ++i) {
        T r = 0;
        for (int e = ca_eqstart[i]; e < ca_eqstart[i + 1]; ++e)
            r += (T)ca_rval[e] * g[ca_rd[e] * ds + ca_ru[e] * us];
        rs[i * rstride] = w * r;
    }
    for (int u = 0; u < c; ++u) {
        T* gu = g + u * us;
        gu[0] = ca_tslot(u, rs, rstride);
        T tp[DIM];
#pragma unroll
        for (int i = 0; i < DIM; ++i) tp[i] = ca_tslot((1 + i) * c + u, rs, rstride);
#pragma unroll
        for (int j = 0; j < DIM; ++j) {
            T s = 0;
#pragma unroll
            for (int i = 0; i < DIM; ++i) s += J[j][i] * tp[i];
            gu[(1 + j) * ds] = s;
        }
    }
}

// The same step from the flat records of ca_stage_flat (the same sums in the same
// order), for NQ QPs at once: QP k's values at g + k * qs, its w * r_i at rs + k * rqs.
// The QPs share each record's loads, and their sums are independent chains.
template <typename T, int DIM, int NQ>
__device__ __forceinline__ void ca_qp_step_flat(T* g, int qs, int ds, int us, const T (&J)[NQ][DIM][DIM],
                                                const T (&w)[NQ], T* rs, int rqs, int c, const CaFlat<T>& f)
{
#pragma unroll
    for (int k = 0; k < NQ; ++k) ca_jt<T, DIM>(g + k * qs, ds, us, J[k], c);
    T r[NQ];
#pragma unroll
    for (int k = 0; k < NQ; ++k) r[k] = 0;
    for (int e = 0; e < f.nr; ++e) {
        const T v = f.vr[e];
        const int o = f.goff[e], ro = f.rout[e];
#pragma unroll
        for (int k = 0; k < NQ; ++k) r[k] += v * g[k * qs + o];
        if (ro >= 0) {
#pragma unroll
            for (int k = 0; k < NQ; ++k) {
                rs[k * rqs + ro] = w[k] * r[k];
                r[k] = 0;
            }
        }
    }
    T t[NQ];
#pragma unroll
    for (int k = 0; k < NQ; ++k) t[k] = 0;
    for (int e = 0; e < f.nt; ++e) {
        const int ri = f.rin[e], go = f.gout[e];
        if (ri >= 0) {
            const T v = f.vt[e];
#pragma unroll
            for (int k = 0; k < NQ; ++k) t[k] += v * rs[k * rqs + ri];
        }
        if (go >= 0) {
#pragma unroll
            for (int k = 0; k < NQ; ++k) {
                g[k * qs + go] = t[k];
                t[k] = 0;
            }
        }
    }
#pragma unroll
    for (int k = 0; k < NQ; ++k)
        for (int u = 0; u < c; ++u) {  // t_ref = J^-1 (t_1..t_DIM)
            T* gu = g + k * qs + u * us;
            T tp[DIM];
#pragma unroll
            for (int i = 0; i < DIM; ++i) tp[i] = gu[(1 + i) * ds];
#pragma unroll
            for (int j = 0; j < DIM; ++j) {
                T s = 0;
#pragma unroll
                for (int i = 0; i < DIM; ++i) s += J[k][j][i] * tp[i];
                gu[(1 + j) * ds] = s;
            }
        }
}

template <typename Sym>
static cudaError_t ca_copy(const Sym& sym, const void* src, size_t bytes, cudaStream_t st)
{
    return bytes ? cudaMemcpyToSymbolAsync(sym, src, bytes, 0, cudaMemcpyHostToDevice, st) : cudaSuccess;
}

// Upload the packed entries (stream-ordered before the next launch on `stream`).
static int ca_set_coeffs(const int* eqstart, const int* rd, const int* ru, const double* rval,
                         const int* slotstart, const int* teq, const double* tval, int n_ent,
                         int n_eq, int n_slot, int device, void* stream)
{
    if (n_ent > CA_MAX_ENT || n_eq > CA_MAX_EQ || n_slot > CA_MAX_SLOT) return (int)cudaErrorInvalidValue;
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return (int)guard.status;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e;
    if ((e = ca_copy(ca_eqstart, eqstart, (n_eq + 1) * sizeof(int), st)) != cudaSuccess) return (int)e;
    if ((e = ca_copy(ca_rd, rd, n_ent * sizeof(int), st)) != cudaSuccess) return (int)e;
    if ((e = ca_copy(ca_ru, ru, n_ent * sizeof(int), st)) != cudaSuccess) return (int)e;
    if ((e = ca_copy(ca_rval, rval, n_ent * sizeof(double), st)) != cudaSuccess) return (int)e;
    if ((e = ca_copy(ca_slotstart, slotstart, (n_slot + 1) * sizeof(int), st)) != cudaSuccess) return (int)e;
    if ((e = ca_copy(ca_teq, teq, n_ent * sizeof(int), st)) != cudaSuccess) return (int)e;
    return (int)ca_copy(ca_tval, tval, n_ent * sizeof(double), st);
}

#define CA_EXPORTS(prefix)                                                                     \
    extern "C" int ca_max_entries() { return CA_MAX_ENT; }                                     \
    extern "C" int ca_max_equations() { return CA_MAX_EQ; }                                    \
    extern "C" int ca_max_slots() { return CA_MAX_SLOT; }                                      \
    extern "C" int prefix##_set_coeffs(const int* eqstart, const int* rd, const int* ru,       \
                                       const double* rval, const int* slotstart,               \
                                       const int* teq, const double* tval, int n_ent,          \
                                       int n_eq, int n_slot, int device, void* stream)         \
    {                                                                                          \
        return ca_set_coeffs(eqstart, rd, ru, rval, slotstart, teq, tval, n_ent, n_eq,         \
                             n_slot, device, stream);                                          \
    }
