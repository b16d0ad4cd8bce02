// Host-side helpers of the preconditioners' setup (C++, built with the host
// compiler at first use and loaded through ctypes by
// l3ster_tpu_torch/solve/hostops.py; a copy of the two functions of the JAX
// package's native/src/hostops.cpp that the port needs).  Both are
// sequential passes over a CSR matrix that a numpy loop would take minutes
// for at production sizes; the Python module keeps numpy versions of the same
// arithmetic and records which one ran.

#include <cstdint>
#include <vector>

extern "C" {

// Zero-fill incomplete LU on a CSR's own sparsity (RILUK level 0,
// cf. solve/Ifpack2Preconditioners.hpp:148).  Column indices must be sorted
// within each row and the diagonal entries must be present.  Factorizes
// in-place in `data`: strictly-lower entries hold L (unit diagonal implied),
// diagonal + upper hold U.  Returns 0 on success, -(row+1) on a zero pivot,
// int64 min on a missing diagonal.
int64_t ilu0_factor_csr(double* data, const int64_t* indices, const int64_t* indptr,
                        int64_t n) {
    std::vector<int64_t> diag_pos(n);
    for (int64_t i = 0; i != n; ++i) {
        int64_t s = indptr[i], e = indptr[i + 1], d = -1;
        // binary search for the diagonal
        int64_t lo = s, hi = e;
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (indices[mid] < i)
                lo = mid + 1;
            else
                hi = mid;
        }
        if (lo < e && indices[lo] == i) d = lo;
        if (d < 0) return INT64_MIN;
        diag_pos[i] = d;
    }
    // scratch: position of column j in the current row i (or -1)
    std::vector<int64_t> col_pos(n, -1);
    for (int64_t i = 0; i != n; ++i) {
        int64_t s = indptr[i], e = indptr[i + 1];
        for (int64_t p = s; p != e; ++p) col_pos[indices[p]] = p;
        for (int64_t kk = s; kk != diag_pos[i]; ++kk) {
            int64_t k = indices[kk];
            double akk = data[diag_pos[k]];
            if (akk == 0.0) {
                for (int64_t p = s; p != e; ++p) col_pos[indices[p]] = -1;
                return -(k + 1);
            }
            double lik = data[kk] / akk;
            data[kk] = lik;
            for (int64_t p = diag_pos[k] + 1; p != indptr[k + 1]; ++p) {
                int64_t cp = col_pos[indices[p]];
                if (cp >= 0) data[cp] -= lik * data[p];
            }
        }
        for (int64_t p = s; p != e; ++p) col_pos[indices[p]] = -1;
    }
    return 0;
}

// Topological levels of a triangular solve: level[i] = 1 + max level of the
// strictly-lower (lower=1) / strictly-upper (lower=0) dependencies of row i.
// One O(nnz) pass (rows in dependency order); feeds the level-scheduled
// solves in l3ster_tpu_torch/solve/tri.py (cf. Ifpack2's local sweep scheduling,
// solve/Ifpack2Preconditioners.hpp:97).
void tri_levels(const int64_t* indices, const int64_t* indptr, int64_t n,
                int lower, int64_t* level) {
    if (lower) {
        for (int64_t i = 0; i != n; ++i) {
            int64_t lv = 0;
            for (int64_t p = indptr[i]; p != indptr[i + 1]; ++p) {
                int64_t j = indices[p];
                if (j < i && level[j] >= lv) lv = level[j] + 1;
            }
            level[i] = lv;
        }
    } else {
        for (int64_t i = n - 1; i >= 0; --i) {
            int64_t lv = 0;
            for (int64_t p = indptr[i]; p != indptr[i + 1]; ++p) {
                int64_t j = indices[p];
                if (j > i && level[j] >= lv) lv = level[j] + 1;
            }
            level[i] = lv;
        }
    }
}

}  // extern "C"
