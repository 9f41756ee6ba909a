// Jonker-Volgenant shortest-augmenting-path linear assignment, C++ core.
//
// The PyTorch port's copy of native/lap_jv.cpp (same C ABI and code), built
// by pyfocusr_tpu_torch/native.py with g++ into the port's host library and
// loaded with ctypes.  Its caller is pyfocusr_tpu_torch/ops/assignment.py's
// lap_host; the numpy loop there (lap_host_plain) is the plain version the
// tests hold this solver to.
//
// Algorithm: per-row Dijkstra on the reduced-cost graph with potentials
// (u, v), O(n^3) worst case, exact.  Matches scipy's result on non-degenerate
// inputs (ties may resolve differently; total cost identical).

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// cost: row-major [n_rows, n_cols], n_rows <= n_cols.
// col_ind: out, length n_rows; col assigned to each row.
// returns 0 on success, nonzero on bad input.
int lap_jv(const double* cost, int64_t n_rows, int64_t n_cols, int64_t* col_ind) {
    if (n_rows <= 0 || n_cols <= 0 || n_rows > n_cols) return 1;
    const double INF = std::numeric_limits<double>::infinity();

    std::vector<double> u(n_rows + 1, 0.0), v(n_cols + 1, 0.0);
    std::vector<int64_t> p(n_cols + 1, 0);     // p[j] = row matched to col j (1-based)
    std::vector<int64_t> way(n_cols + 1, 0);
    std::vector<double> minv(n_cols + 1);
    std::vector<char> used(n_cols + 1);

    for (int64_t i = 1; i <= n_rows; ++i) {
        p[0] = i;
        int64_t j0 = 0;
        std::fill(minv.begin(), minv.end(), INF);
        std::fill(used.begin(), used.end(), 0);
        do {
            used[j0] = 1;
            const int64_t i0 = p[j0];
            double delta = INF;
            int64_t j1 = -1;
            const double* row = cost + (i0 - 1) * n_cols;
            const double ui0 = u[i0];
            for (int64_t j = 1; j <= n_cols; ++j) {
                if (!used[j]) {
                    const double cur = row[j - 1] - ui0 - v[j];
                    if (cur < minv[j]) {
                        minv[j] = cur;
                        way[j] = j0;
                    }
                    if (minv[j] < delta) {
                        delta = minv[j];
                        j1 = j;
                    }
                }
            }
            // Non-finite costs (NaN rows, all-inf remaining columns) leave
            // j1 == -1: without this guard the p[-1] access below is UB and
            // the augmentation spins forever.  Report bad input instead.
            if (j1 < 0) return 2;
            for (int64_t j = 0; j <= n_cols; ++j) {
                if (used[j]) {
                    u[p[j]] += delta;
                    v[j] -= delta;
                } else {
                    minv[j] -= delta;
                }
            }
            j0 = j1;
        } while (p[j0] != 0);
        // Augment.
        do {
            const int64_t j1 = way[j0];
            p[j0] = p[j1];
            j0 = j1;
        } while (j0 != 0);
    }

    for (int64_t i = 0; i < n_rows; ++i) col_ind[i] = -1;
    for (int64_t j = 1; j <= n_cols; ++j) {
        if (p[j] > 0 && p[j] <= n_rows) col_ind[p[j] - 1] = j - 1;
    }
    return 0;
}

}  // extern "C"
