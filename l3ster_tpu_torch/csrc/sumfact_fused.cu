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
// What bounds it on this card: at p = 4 (n1 = 5, q1 = 8, c = 4) an element reads
// 500 + 4608 + 512 values, writes 500, and does ~380 kFLOP: over the 17,456-hex
// cylinder mesh ~430 MB (0.128 ms at 3.35 TB/s) against ~6.6 GFLOP (0.10 ms at
// 67 TFLOP/s f32), so both bounds are close and the kernel must waste neither
// instructions nor bytes.  The design:
// - Compile-time orders.  Each (n1, q1) the port uses (p = 1..6 at q1 = 2p, the
//   default quadrature, and q1 = p + 1) is its own instantiation, so every sweep is
//   fully unrolled: a thread owns one 1D line, loads its n1 (or q1) inputs once
//   into registers and writes all q1 (or n1) outputs; the tables N1, D1 sit in
//   __constant__ memory at compile-time offsets, so they are operands of the FMAs
//   themselves, and no index is divided at run time.
// - Channels are independent in the sweeps: the block is 4 groups of 64 threads, a
//   group sweeps its channels alone and syncs on its own named barrier, so an
//   element takes three block-wide barriers: after its loads and around the
//   per-QP step.
// - Layouts.  Each sweep writes its output with the line axis outermost and reads
//   its input with an odd stride (n1 at even p), and the QP tensors are channel-major
//   (d, u, q), so the per-QP step of const_coeffs.cuh reads them at stride 1.
// - The element's nodal values, then its J^-1 and w (Q*dim^2 + Q values), come into
//   shared memory by 16-byte cp.async started at the beginning, the geometry overlapped
//   with the forward sweeps (read from device memory directly where the staging
//   does not fit); A's entries are copied into shared memory as flat record lists
//   with their offsets (const_coeffs.cuh: ca_stage_flat), so the per-QP step makes
//   one pass over each and reads no __constant__ table; a thread takes two QPs
//   through it at once where their w * r fit (shared record loads, two independent
//   chains: the step is latency-bound at 24 warps per SM).
// - Any other (n1, q1), and an element that does not fit the unrolled kernel's
//   layout, runs the run-time-sized sumfact_generic_kernel: every stage a loop over
//   the table entries from shared memory (a contraction per stage) and the per-QP
//   step of const_coeffs.cuh, with the tables N1, D1 read from device memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (l3ster_tpu_torch/ops/sumfact_fused.py builds and loads it with ctypes).

#include <type_traits>

#include "async_copy.cuh"
#include "const_coeffs.cuh"

#define SF_TPC 64      // threads of one channel group
#define SF_GROUPS 4    // channel groups of a block, at most
#define SF_MAXN 8
#define SF_MAXQ 16

// the 1D tables at [q * SF_MAXN + i]: N1 then D1
__constant__ float sf_tab_f[2][SF_MAXQ * SF_MAXN];
__constant__ double sf_tab_d[2][SF_MAXQ * SF_MAXN];

template <typename T>
__device__ __forceinline__ T sf_tab(int k, int q, int i)
{
    if constexpr (sizeof(T) == 4)
        return sf_tab_f[k][q * SF_MAXN + i];
    else
        return sf_tab_d[k][q * SF_MAXN + i];
}

__device__ __forceinline__ void group_sync(int g)
{
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(SF_TPC) : "memory");
}

// Copy n values from device memory to shared memory, 16 bytes at a time where both
// sides allow it; committed by the caller.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n, int tid, int nt)
{
    if (((reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst)) & 15) == 0 && (n * sizeof(T)) % 16 == 0) {
        const int n16 = (int)(n * sizeof(T) / 16);
        for (int k = tid; k < n16; k += nt)
            cp_async<16>(reinterpret_cast<char*>(dst) + 16 * k, reinterpret_cast<const char*>(src) + 16 * k, true);
    } else {
        for (int k = tid; k < n; k += nt) cp_async<sizeof(T)>(dst + k, src + k, true);
    }
}

// The register budget is set for three blocks per SM (80 registers), and for two
// where the 3D sweeps spilled under that budget (even n1, and q1 = n1).
template <typename T, int DIM, int N, int QQ>
__global__ void __launch_bounds__(SF_TPC * SF_GROUPS, (DIM == 3 && (N % 2 == 0 || N == QQ)) ? 2 : 3) sumfact_kernel(
    const T* __restrict__ x, const T* __restrict__ ji, const T* __restrict__ wq,
    T* __restrict__ y, int c, int n_eq, int staged, int pair)
{
    constexpr int NN = DIM == 3 ? N * N * N : N * N;        // nodes
    constexpr int Q = DIM == 3 ? QQ * QQ * QQ : QQ * QQ;    // QPs
    constexpr int RS = (DIM + 1) * Q;                       // one channel's QP tensors
    constexpr int SC = DIM == 3 ? 3 * N * QQ * QQ : 2 * QQ * N;  // a group's stage scratch
    const int e = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const int G = nt / SF_TPC, g = tid / SF_TPC, lt = tid - g * SF_TPC;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Js = reinterpret_cast<T*>(smem_raw);       // (Q, dim, dim), if staged
    T* Ws = Js + (staged ? Q * DIM * DIM : 0);    // (Q,), if staged
    T* xe = Ws + (staged ? Q : 0);                // (n1^dim, c): the element's nodal values
    T* S3 = xe + NN * c;                          // (c, dim+1, Q): channel u at S3 + u * RS
    T* scratch = S3 + c * RS;                     // G x SC; w * r of the per-QP step
    T* sc = scratch + g * SC;
    T* ent = scratch + max(G * SC, (1 + pair) * n_eq * nt);  // A's entries (ca_stage_flat)
    int* ient = reinterpret_cast<int*>(ent + 2 * ca_eqstart[n_eq] + (DIM + 1) * c);

    const T* jie = ji + (size_t)e * Q * DIM * DIM;
    const T* we = wq + (size_t)e * Q;
    stage(xe, x + (size_t)e * NN * c, NN * c, tid, nt);
    cp_async_commit();
    if (staged) {
        stage(Js, jie, Q * DIM * DIM, tid, nt);
        stage(Ws, we, Q, tid, nt);
    }
    cp_async_commit();
    const CaFlat<T> coef = ca_stage_flat(ient, ent, n_eq, c, (DIM + 1) * c, Q, RS, nt, tid, nt);
    T* ye = y + (size_t)e * NN * c;
    cp_async_wait<1>();
    __syncthreads();  // the nodal values and A's entries are in

    // ---- nodes -> QPs, per channel: S3[u] = (v, ddx, ddy[, ddz]), each (Q,)
    for (int u = g; u < c; u += G) {
        T* S3u = S3 + u * RS;
        if constexpr (DIM == 3) {
            T* T1 = S3u;  // AX, ADX: [qx][z][y], until the z sweep writes S3u
            for (int t = lt; t < N * N; t += SF_TPC) {  // x lines, t = z * N + y
                T in[N];
#pragma unroll
                for (int i = 0; i < N; ++i) in[i] = xe[(t * N + i) * c + u];
#pragma unroll
                for (int o = 0; o < QQ; ++o) {
                    T sn = 0, sd = 0;
#pragma unroll
                    for (int i = 0; i < N; ++i) {
                        sn += sf_tab<T>(0, o, i) * in[i];
                        sd += sf_tab<T>(1, o, i) * in[i];
                    }
                    T1[o * N * N + t] = sn;
                    T1[QQ * N * N + o * N * N + t] = sd;
                }
            }
            group_sync(g);
            for (int t = lt; t < QQ * N; t += SF_TPC) {  // y lines, t = qx * N + z
                T in[N], in2[N];
#pragma unroll
                for (int i = 0; i < N; ++i) {
                    in[i] = T1[t * N + i];
                    in2[i] = T1[QQ * N * N + t * N + i];
                }
#pragma unroll
                for (int o = 0; o < QQ; ++o) {  // B, BDY, BDX: [qy][qx][z]
                    T sb = 0, sdy = 0, sdx = 0;
#pragma unroll
                    for (int i = 0; i < N; ++i) {
                        sb += sf_tab<T>(0, o, i) * in[i];
                        sdy += sf_tab<T>(1, o, i) * in[i];
                        sdx += sf_tab<T>(0, o, i) * in2[i];
                    }
                    sc[o * QQ * N + t] = sb;
                    sc[QQ * QQ * N + o * QQ * N + t] = sdy;
                    sc[2 * QQ * QQ * N + o * QQ * N + t] = sdx;
                }
            }
            group_sync(g);
            for (int t = lt; t < QQ * QQ; t += SF_TPC) {  // z lines, t = qy * QQ + qx
                T in[N], in2[N], in3[N];
#pragma unroll
                for (int i = 0; i < N; ++i) {
                    in[i] = sc[t * N + i];
                    in2[i] = sc[QQ * QQ * N + t * N + i];
                    in3[i] = sc[2 * QQ * QQ * N + t * N + i];
                }
#pragma unroll
                for (int o = 0; o < QQ; ++o) {
                    T v = 0, dz = 0, dy = 0, dx = 0;
#pragma unroll
                    for (int i = 0; i < N; ++i) {
                        v += sf_tab<T>(0, o, i) * in[i];
                        dz += sf_tab<T>(1, o, i) * in[i];
                        dy += sf_tab<T>(0, o, i) * in2[i];
                        dx += sf_tab<T>(0, o, i) * in3[i];
                    }
                    const int qi = o * QQ * QQ + t;
                    S3u[qi] = v;
                    S3u[Q + qi] = dx;
                    S3u[2 * Q + qi] = dy;
                    S3u[3 * Q + qi] = dz;
                }
            }
            group_sync(g);  // the next channel's y sweep reuses the scratch
        } else {
            T* T1 = sc;  // AX, ADX: [qx][y]
            for (int t = lt; t < N; t += SF_TPC) {  // x lines, t = y
                T in[N];
#pragma unroll
                for (int i = 0; i < N; ++i) in[i] = xe[(t * N + i) * c + u];
#pragma unroll
                for (int o = 0; o < QQ; ++o) {
                    T sn = 0, sd = 0;
#pragma unroll
                    for (int i = 0; i < N; ++i) {
                        sn += sf_tab<T>(0, o, i) * in[i];
                        sd += sf_tab<T>(1, o, i) * in[i];
                    }
                    T1[o * N + t] = sn;
                    T1[QQ * N + o * N + t] = sd;
                }
            }
            group_sync(g);
            for (int t = lt; t < QQ; t += SF_TPC) {  // y lines, t = qx
                T in[N], in2[N];
#pragma unroll
                for (int i = 0; i < N; ++i) {
                    in[i] = T1[t * N + i];
                    in2[i] = T1[QQ * N + t * N + i];
                }
#pragma unroll
                for (int o = 0; o < QQ; ++o) {
                    T v = 0, dy = 0, dx = 0;
#pragma unroll
                    for (int i = 0; i < N; ++i) {
                        v += sf_tab<T>(0, o, i) * in[i];
                        dy += sf_tab<T>(1, o, i) * in[i];
                        dx += sf_tab<T>(0, o, i) * in2[i];
                    }
                    const int qi = o * QQ + t;
                    S3u[qi] = v;
                    S3u[Q + qi] = dx;
                    S3u[2 * Q + qi] = dy;
                }
            }
            group_sync(g);
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // every channel's QP tensors and the staged geometry are in

    // ---- per QP, in place: S3 becomes (t0, t_ref x, t_ref y[, t_ref z]); with pair,
    // two QPs (q and q + nt) a thread at a time, w * r of the second at scratch + n_eq * nt
    auto qp = [&](int q, auto nq) {
        constexpr int NQ = decltype(nq)::value;
        T J[NQ][DIM][DIM], wk[NQ];
#pragma unroll
        for (int k = 0; k < NQ; ++k) {
            const int qk = q + k * nt;
            const T* jq = staged ? Js + qk * DIM * DIM : jie + qk * DIM * DIM;
#pragma unroll
            for (int j = 0; j < DIM; ++j)
#pragma unroll
                for (int i = 0; i < DIM; ++i) J[k][j][i] = jq[j * DIM + i];
            wk[k] = staged ? Ws[qk] : we[qk];
        }
        ca_qp_step_flat<T, DIM, NQ>(S3 + q, nt, Q, RS, J, wk, scratch + tid, n_eq * nt, c, coef);
    };
    int q = tid;
    if (pair)
        for (; q + nt < Q; q += 2 * nt) qp(q, std::integral_constant<int, 2>());
    for (; q < Q; q += nt) qp(q, std::integral_constant<int, 1>());
    __syncthreads();  // every QP is done; the scratch is free again

    // ---- QPs -> nodes, per channel
    for (int u = g; u < c; u += G) {
        const T* S3u = S3 + u * RS;
        if constexpr (DIM == 3) {
            for (int t = lt; t < QQ * QQ; t += SF_TPC) {  // z lines, t = qy * QQ + qx
                T t0[QQ], tx[QQ], ty[QQ], tz[QQ];
#pragma unroll
                for (int o = 0; o < QQ; ++o) {
                    t0[o] = S3u[o * QQ * QQ + t];
                    tx[o] = S3u[Q + o * QQ * QQ + t];
                    ty[o] = S3u[2 * Q + o * QQ * QQ + t];
                    tz[o] = S3u[3 * Q + o * QQ * QQ + t];
                }
#pragma unroll
                for (int i = 0; i < N; ++i) {  // Bb, Bby, Bbx: [z][qy][qx]
                    T sb = 0, sby = 0, sbx = 0;
#pragma unroll
                    for (int o = 0; o < QQ; ++o) {
                        sb += sf_tab<T>(0, o, i) * t0[o] + sf_tab<T>(1, o, i) * tz[o];
                        sby += sf_tab<T>(0, o, i) * ty[o];
                        sbx += sf_tab<T>(0, o, i) * tx[o];
                    }
                    sc[i * QQ * QQ + t] = sb;
                    sc[N * QQ * QQ + i * QQ * QQ + t] = sby;
                    sc[2 * N * QQ * QQ + i * QQ * QQ + t] = sbx;
                }
            }
            group_sync(g);
            T* A1 = S3 + u * RS;  // a, ax: [y][qx][z], over this channel's spent QP tensors
            for (int t = lt; t < N * QQ; t += SF_TPC) {  // y lines, t = z * QQ + qx
                const int z = t / QQ, qx = t - z * QQ;
                const int base = z * QQ * QQ + qx;
                T b0[QQ], by[QQ], bx[QQ];
#pragma unroll
                for (int o = 0; o < QQ; ++o) {
                    b0[o] = sc[base + o * QQ];
                    by[o] = sc[N * QQ * QQ + base + o * QQ];
                    bx[o] = sc[2 * N * QQ * QQ + base + o * QQ];
                }
#pragma unroll
                for (int i = 0; i < N; ++i) {
                    T sa = 0, sx = 0;
#pragma unroll
                    for (int o = 0; o < QQ; ++o) {
                        sa += sf_tab<T>(0, o, i) * b0[o] + sf_tab<T>(1, o, i) * by[o];
                        sx += sf_tab<T>(0, o, i) * bx[o];
                    }
                    A1[(i * QQ + qx) * N + z] = sa;
                    A1[N * QQ * N + (i * QQ + qx) * N + z] = sx;
                }
            }
            group_sync(g);
            for (int t = lt; t < N * N; t += SF_TPC) {  // x lines, t = y * N + z
                const int yy = t / N, z = t - yy * N;
                const T* a0 = A1 + yy * QQ * N + z;
                T av[QQ], ax[QQ];
#pragma unroll
                for (int o = 0; o < QQ; ++o) {
                    av[o] = a0[o * N];
                    ax[o] = a0[N * QQ * N + o * N];
                }
#pragma unroll
                for (int i = 0; i < N; ++i) {
                    T s = 0;
#pragma unroll
                    for (int o = 0; o < QQ; ++o) s += sf_tab<T>(0, o, i) * av[o] + sf_tab<T>(1, o, i) * ax[o];
                    ye[((z * N + yy) * N + i) * c + u] = s;
                }
            }
        } else {
            T* A1 = sc;  // a, ax: [qx][y]
            for (int t = lt; t < QQ; t += SF_TPC) {  // y lines, t = qx
                T t0[QQ], tx[QQ], ty[QQ];
#pragma unroll
                for (int o = 0; o < QQ; ++o) {
                    t0[o] = S3u[o * QQ + t];
                    tx[o] = S3u[Q + o * QQ + t];
                    ty[o] = S3u[2 * Q + o * QQ + t];
                }
#pragma unroll
                for (int i = 0; i < N; ++i) {
                    T sa = 0, sx = 0;
#pragma unroll
                    for (int o = 0; o < QQ; ++o) {
                        sa += sf_tab<T>(0, o, i) * t0[o] + sf_tab<T>(1, o, i) * ty[o];
                        sx += sf_tab<T>(0, o, i) * tx[o];
                    }
                    A1[t * N + i] = sa;
                    A1[QQ * N + t * N + i] = sx;
                }
            }
            group_sync(g);
            for (int t = lt; t < N; t += SF_TPC) {  // x lines, t = y
                T av[QQ], ax[QQ];
#pragma unroll
                for (int o = 0; o < QQ; ++o) {
                    av[o] = A1[o * N + t];
                    ax[o] = A1[QQ * N + o * N + t];
                }
#pragma unroll
                for (int i = 0; i < N; ++i) {
                    T s = 0;
#pragma unroll
                    for (int o = 0; o < QQ; ++o) s += sf_tab<T>(0, o, i) * av[o] + sf_tab<T>(1, o, i) * ax[o];
                    ye[(t * N + i) * c + u] = s;
                }
            }
            group_sync(g);  // the next channel's y sweep reuses A1
        }
    }
}

// ---- the run-time-sized kernel, for the orders without an unrolled instantiation

#define SF_GENERIC_THREADS 256

// One 1D contraction stage over a (A, I, B) tensor into (A, O, B):
//   out[a, o, b] = sum_i tab1[o*so + i*si] * in1[a, i, b]  (+ the same with tab2, in2)
// so = I, si = 1 reads an (O, I) table forwards; so = 1, si = O reads an (I, O) one transposed.
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

// One element per block; every stage tensor in shared memory, sized at launch.
template <typename T, int DIM>
__global__ void __launch_bounds__(SF_GENERIC_THREADS) sumfact_generic_kernel(
    const T* __restrict__ x, const T* __restrict__ ji, const T* __restrict__ w,
    const T* __restrict__ N1, const T* __restrict__ D1, T* __restrict__ y,
    int n1, int q1, int c, int n_eq)
{
    const int e = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    int nn = 1, Q = 1;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
        nn *= n1;
        Q *= q1;
    }
    const int nb = nn / n1;           // n1^(dim-1)
    const int s1 = nb * q1 * c;       // one x-stage tensor: (.., qx, c)
    const int s2 = n1 * q1 * q1 * c;  // one y-stage tensor of 3D: (z, qy, qx, c)
    const int qc = Q * c;             // one QP tensor: (q, c)

    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* tN = reinterpret_cast<T*>(smem_raw);  // (q1, n1)
    T* tD = tN + q1 * n1;                    // (q1, n1)
    T* X = tD + q1 * n1;                     // (n1^dim, c) nodal tile
    T* S1 = X + nn * c;                      // 2 x-stage tensors
    T* S2 = S1 + 2 * s1;                     // 3 y-stage tensors (3D only)
    T* S3 = S2 + (DIM == 3 ? 3 * s2 : 0);    // dim+1 QP tensors
    T* R = S3 + (DIM + 1) * qc;              // (n_eq, nt): w * r of each thread's QP

    for (int k = tid; k < q1 * n1; k += nt) {
        tN[k] = N1[k];
        tD[k] = D1[k];
    }
    const T* xe = x + (size_t)e * nn * c;
    for (int k = tid; k < nn * c; k += nt) X[k] = xe[k];
    __syncthreads();

    // ---- nodes -> QPs; S3 holds (v, ddx, ddy[, ddz]), each (q, c)
    const T* none = nullptr;
    T* ax = S1;
    T* adx = S1 + s1;
    contract(ax, X, tN, none, tN, nb, n1, q1, c, n1, 1);  // x: (.., x, c) -> (.., qx, c)
    contract(adx, X, tD, none, tD, nb, n1, q1, c, n1, 1);
    __syncthreads();
    if (DIM == 3) {
        T *b = S2, *bdy = S2 + s2, *bdx = S2 + 2 * s2;
        contract(b, ax, tN, none, tN, n1, n1, q1, q1 * c, n1, 1);  // y
        contract(bdy, ax, tD, none, tD, n1, n1, q1, q1 * c, n1, 1);
        contract(bdx, adx, tN, none, tN, n1, n1, q1, q1 * c, n1, 1);
        __syncthreads();
        contract(S3, b, tN, none, tN, 1, n1, q1, q1 * q1 * c, n1, 1);  // z
        contract(S3 + 3 * qc, b, tD, none, tD, 1, n1, q1, q1 * q1 * c, n1, 1);
        contract(S3 + 2 * qc, bdy, tN, none, tN, 1, n1, q1, q1 * q1 * c, n1, 1);
        contract(S3 + qc, bdx, tN, none, tN, 1, n1, q1, q1 * q1 * c, n1, 1);
    } else {
        contract(S3, ax, tN, none, tN, 1, n1, q1, q1 * c, n1, 1);  // y
        contract(S3 + 2 * qc, ax, tD, none, tD, 1, n1, q1, q1 * c, n1, 1);
        contract(S3 + qc, adx, tN, none, tN, 1, n1, q1, q1 * c, n1, 1);
    }
    __syncthreads();

    // ---- per QP, in place: S3 becomes (t0, t_ref x, t_ref y[, t_ref z])
    for (int q = tid; q < Q; q += nt) {
        const T* jq = ji + ((size_t)e * Q + q) * DIM * DIM;
        T J[DIM][DIM];
#pragma unroll
        for (int j = 0; j < DIM; ++j)
#pragma unroll
            for (int i = 0; i < DIM; ++i) J[j][i] = jq[j * DIM + i];
        ca_qp_step<T, DIM>(S3 + q * c, qc, 1, J, w[(size_t)e * Q + q], R + tid, nt, c, n_eq);
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
        contract(by, ty, tN, none, tN, 1, q1, n1, q1 * q1 * c, 1, n1);
        contract(bx, tx, tN, none, tN, 1, q1, n1, q1 * q1 * c, 1, n1);
        __syncthreads();
        contract(a, b, tN, by, tD, n1, q1, n1, q1 * c, 1, n1);  // y
        contract(ax2, bx, tN, none, tN, n1, q1, n1, q1 * c, 1, n1);
    } else {
        contract(a, t0, tN, ty, tD, 1, q1, n1, q1 * c, 1, n1);  // y
        contract(ax2, tx, tN, none, tN, 1, q1, n1, q1 * c, 1, n1);
    }
    __syncthreads();
    contract(y + (size_t)e * nn * c, a, tN, ax2, tD, nb, q1, n1, c, 1, n1);  // x, to device memory
}

// The (n1, q1) pairs with an unrolled kernel: p = 1..6 at q1 = 2p (QO = 4p - 2, the default
// quadrature) and q1 = p + 1 (QO = 2p).
#define SF_ORDERS(X) \
    X(2, 2) X(3, 3) X(3, 4) X(4, 4) X(4, 6) X(5, 5) X(5, 8) X(6, 6) X(6, 10) X(7, 7) X(7, 12)

template <typename T>
static const void* kernel_for(int dim, int n1, int q1)
{
#define SF_PICK(N_, Q_)                                                                        \
    if (n1 == N_ && q1 == Q_)                                                                  \
        return dim == 3 ? (const void*)sumfact_kernel<T, 3, N_, Q_> : (const void*)sumfact_kernel<T, 2, N_, Q_>;
    SF_ORDERS(SF_PICK)
#undef SF_PICK
    return nullptr;
}

template <typename T>
static const void* generic_for(int dim)
{
    if (dim == 2) return (const void*)sumfact_generic_kernel<T, 2>;
    if (dim == 3) return (const void*)sumfact_generic_kernel<T, 3>;
    return nullptr;
}

// groups == 0: the generic kernel on SF_GENERIC_THREADS threads, with the device
// tables N1, D1 (q1, n1); else the unrolled one on groups channel groups
template <typename T>
static int launch(const T* x, const T* ji, const T* w, const T* N1, const T* D1, T* y, int E, int c,
                  int dim, int n1, int q1, int n_eq, int groups, int staged, int pair, int smem,
                  int device, void* stream)
{
    const bool generic = groups == 0;
    const void* fn = generic ? generic_for<T>(dim) : (dim == 2 || dim == 3) ? kernel_for<T>(dim, n1, q1) : nullptr;
    if (fn == nullptr || groups < 0 || groups > SF_GROUPS || (generic && (N1 == nullptr || D1 == nullptr)))
        return (int)cudaErrorInvalidValue;
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return (int)guard.status;
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    void* args_u[] = {&x, &ji, &w, &y, &c, &n_eq, &staged, &pair};
    void* args_g[] = {&x, &ji, &w, &N1, &D1, &y, &n1, &q1, &c, &n_eq};
    e = cudaLaunchKernel(fn, dim3(E), dim3(generic ? SF_GENERIC_THREADS : groups * SF_TPC),
                         generic ? (void**)args_g : (void**)args_u, (size_t)smem, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

CA_EXPORTS(sf)

extern "C" {

// Upload the (q1, n1) tables N1, D1 (row-major f64), stream-ordered before the next launch.
int sf_set_tables(const double* N1, const double* D1, int q1, int n1, int device, void* stream)
{
    if (q1 > SF_MAXQ || n1 > SF_MAXN) return (int)cudaErrorInvalidValue;
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return (int)guard.status;
    static double td[2][SF_MAXQ * SF_MAXN];
    static float tf[2][SF_MAXQ * SF_MAXN];
    for (int k = 0; k < 2; ++k)
        for (int o = 0; o < SF_MAXQ; ++o)
            for (int i = 0; i < SF_MAXN; ++i) {
                const double v = (o < q1 && i < n1) ? (k ? D1 : N1)[o * n1 + i] : 0.0;
                td[k][o * SF_MAXN + i] = v;
                tf[k][o * SF_MAXN + i] = (float)v;
            }
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = cudaMemcpyToSymbolAsync(sf_tab_d, td, sizeof(td), 0, cudaMemcpyHostToDevice, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemcpyToSymbolAsync(sf_tab_f, tf, sizeof(tf), 0, cudaMemcpyHostToDevice, st);
}

// N1, D1: the generic kernel's device tables (groups == 0), else unused
int sf_f32(const float* x, const float* ji, const float* w, const float* N1, const float* D1, float* y,
           int E, int c, int dim, int n1, int q1, int n_eq, int groups, int staged, int pair, int smem,
           int device, void* stream)
{
    return launch<float>(x, ji, w, N1, D1, y, E, c, dim, n1, q1, n_eq, groups, staged, pair, smem, device, stream);
}

int sf_f64(const double* x, const double* ji, const double* w, const double* N1, const double* D1,
           double* y, int E, int c, int dim, int n1, int q1, int n_eq, int groups, int staged, int pair,
           int smem, int device, void* stream)
{
    return launch<double>(x, ji, w, N1, D1, y, E, c, dim, n1, q1, n_eq, groups, staged, pair, smem, device, stream);
}

// Resident blocks per SM of one instantiation at a launch shape (< 0: a CUDA error).
int sf_occupancy(int f64, int generic, int dim, int n1, int q1, int threads, int smem, int device)
{
    const void* fn = generic ? (f64 ? generic_for<double>(dim) : generic_for<float>(dim))
                             : (f64 ? kernel_for<double>(dim, n1, q1) : kernel_for<float>(dim, n1, q1));
    if (fn == nullptr) return -(int)cudaErrorInvalidValue;
    DeviceGuard guard(device);
    if (guard.status != cudaSuccess) return -(int)guard.status;
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return -(int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, (size_t)smem);
    return e == cudaSuccess ? blocks : -(int)e;
}

}  // extern "C"
