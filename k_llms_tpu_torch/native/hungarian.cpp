// Rectangular linear sum assignment (Hungarian / Jonker-Volgenant style).
//
// Native replacement for scipy.optimize.linear_sum_assignment as used by the
// reference list aligner (k_llms/utils/consensus_utils.py:20,372).
// Shortest augmenting path formulation over a dense cost matrix, matching the
// algorithm scipy's rectangular_lsap uses (ties broken by first-scanned column) so
// assignments agree on the aligner's 1-sim cost matrices.
//
// Solves min-cost assignment of each row to a distinct column for an r x c matrix
// with r <= c (caller transposes when r > c).

#include <algorithm>
#include <cstdint>
#include <vector>
#include <limits>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// Augmenting-path LSAP for nr <= nc. cost is row-major nr*nc.
// col4row[row] = assigned column. Returns 0 on success, -1 if infeasible.
int solve_lsap(const double* cost, int64_t nr, int64_t nc, int64_t* col4row) {
    std::vector<double> u(static_cast<size_t>(nr), 0.0);   // row duals
    std::vector<double> v(static_cast<size_t>(nc), 0.0);   // col duals
    std::vector<int64_t> row4col(static_cast<size_t>(nc), -1);
    for (int64_t r = 0; r < nr; ++r) col4row[r] = -1;

    std::vector<double> shortest(static_cast<size_t>(nc));
    std::vector<int64_t> pred(static_cast<size_t>(nc));
    std::vector<char> done(static_cast<size_t>(nc));

    for (int64_t cur_row = 0; cur_row < nr; ++cur_row) {
        // Dijkstra from cur_row to the nearest unassigned column.
        std::fill(shortest.begin(), shortest.end(), kInf);
        std::fill(done.begin(), done.end(), 0);
        std::fill(pred.begin(), pred.end(), cur_row);

        double min_val = 0.0;
        int64_t i = cur_row;
        int64_t sink = -1;
        while (sink == -1) {
            double lowest = kInf;
            int64_t j_lowest = -1;
            for (int64_t j = 0; j < nc; ++j) {
                if (done[static_cast<size_t>(j)]) continue;
                double r_cost = min_val + cost[i * nc + j] - u[static_cast<size_t>(i)] - v[static_cast<size_t>(j)];
                if (r_cost < shortest[static_cast<size_t>(j)]) {
                    shortest[static_cast<size_t>(j)] = r_cost;
                    pred[static_cast<size_t>(j)] = i;
                }
                if (shortest[static_cast<size_t>(j)] < lowest) {
                    lowest = shortest[static_cast<size_t>(j)];
                    j_lowest = j;
                }
            }
            if (j_lowest == -1 || lowest == kInf) return -1;  // infeasible
            done[static_cast<size_t>(j_lowest)] = 1;
            min_val = lowest;
            if (row4col[static_cast<size_t>(j_lowest)] == -1) {
                sink = j_lowest;
            } else {
                i = row4col[static_cast<size_t>(j_lowest)];
            }
        }

        // Update duals.
        u[static_cast<size_t>(cur_row)] += min_val;
        for (int64_t r = 0; r < nr; ++r) {
            if (r == cur_row) continue;
            if (col4row[r] != -1 && done[static_cast<size_t>(col4row[r])]) {
                u[static_cast<size_t>(r)] += min_val - shortest[static_cast<size_t>(col4row[r])];
            }
        }
        for (int64_t j = 0; j < nc; ++j) {
            if (done[static_cast<size_t>(j)]) v[static_cast<size_t>(j)] -= min_val - shortest[static_cast<size_t>(j)];
        }

        // Augment along the path back from sink.
        int64_t j = sink;
        while (true) {
            int64_t r = pred[static_cast<size_t>(j)];
            int64_t next_j = (r == cur_row) ? -1 : col4row[r];
            row4col[static_cast<size_t>(j)] = r;
            col4row[r] = j;
            if (r == cur_row) break;
            j = next_j;
        }
    }
    return 0;
}

}  // namespace

extern "C" {

// row_ind/col_ind must have space for min(nr, nc) entries. Returns 0 on success.
int kllms_linear_sum_assignment(const double* cost, int64_t nr, int64_t nc,
                                int64_t* row_ind, int64_t* col_ind) {
    const bool transposed = nr > nc;
    std::vector<double> ct;
    const double* c = cost;
    int64_t r = nr, k = nc;
    if (transposed) {
        ct.resize(static_cast<size_t>(nr) * static_cast<size_t>(nc));
        for (int64_t i = 0; i < nr; ++i)
            for (int64_t j = 0; j < nc; ++j)
                ct[static_cast<size_t>(j) * nr + i] = cost[i * nc + j];
        c = ct.data();
        r = nc;
        k = nr;
    }
    std::vector<int64_t> col4row(static_cast<size_t>(r));
    if (solve_lsap(c, r, k, col4row.data()) != 0) return -1;
    if (!transposed) {
        for (int64_t i = 0; i < r; ++i) {
            row_ind[i] = i;
            col_ind[i] = col4row[static_cast<size_t>(i)];
        }
    } else {
        // We solved the transpose: rows there are original columns. Report sorted
        // by original row index, like scipy does for wide-vs-tall inputs.
        std::vector<std::pair<int64_t, int64_t>> pairs(static_cast<size_t>(r));
        for (int64_t i = 0; i < r; ++i)
            pairs[static_cast<size_t>(i)] = {col4row[static_cast<size_t>(i)], i};
        std::sort(pairs.begin(), pairs.end());
        for (int64_t i = 0; i < r; ++i) {
            row_ind[i] = pairs[static_cast<size_t>(i)].first;
            col_ind[i] = pairs[static_cast<size_t>(i)].second;
        }
    }
    return 0;
}

}  // extern "C"
