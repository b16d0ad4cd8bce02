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

#pragma once

#include <cuda_runtime.h>

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

// Makes `device` current for the calling thread and restores the previous
// device on scope exit, as PyTorch's device guard does around an op.
struct DeviceGuard {
    int prev = -1;
    cudaError_t status;
    explicit DeviceGuard(int device) {
        status = cudaGetDevice(&prev);
        if (status == cudaSuccess && prev != device) status = cudaSetDevice(device);
    }
    ~DeviceGuard() {
        if (prev >= 0) cudaSetDevice(prev);
    }
};

// t[s] of one QP: the A^T half of the algebra, from r_i held at rs[i * stride].
template <typename T>
__device__ __forceinline__ T ca_tslot(int s, const T* rs, int stride)
{
    T t = 0;
    for (int e = ca_slotstart[s]; e < ca_slotstart[s + 1]; ++e) t += (T)ca_tval[e] * rs[ca_teq[e] * stride];
    return t;
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
