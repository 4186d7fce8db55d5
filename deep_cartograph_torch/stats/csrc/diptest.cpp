// Batch Hartigan dip statistic, OpenMP-parallel over features.
//
// C++ form of the AS 217 algorithm of deep_cartograph_torch/stats/dip.py,
// for the filter: 50k features x 100k frames is too slow for a Python
// loop; here every feature column is an independent task.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

void gcm_touchpoints(const double* x, int n, std::vector<int64_t>& mn) {
    mn[0] = 0;
    for (int j = 1; j < n; ++j) {
        mn[j] = j - 1;
        while (true) {
            int64_t mnj = mn[j];
            if (mnj == 0) break;
            int64_t mnmnj = mn[mnj];
            if ((x[j] - x[mnj]) * double(mnj - mnmnj) <
                (x[mnj] - x[mnmnj]) * double(j - mnj))
                break;
            mn[j] = mnmnj;
        }
    }
}

void lcm_touchpoints(const double* x, int n, std::vector<int64_t>& mj) {
    mj[n - 1] = n - 1;
    for (int j = n - 2; j >= 0; --j) {
        mj[j] = j + 1;
        while (true) {
            int64_t mjj = mj[j];
            if (mjj == n - 1) break;
            int64_t mjmjj = mj[mjj];
            if ((x[j] - x[mjj]) * double(mjj - mjmjj) <
                (x[mjj] - x[mjmjj]) * double(j - mjj))
                break;
            mj[j] = mjmjj;
        }
    }
}

double dip_statistic_sorted(const double* x, int n) {
    if (n < 2 || x[0] == x[n - 1]) return 0.0;
    if (n < 4) return 1.0 / (2.0 * n);

    std::vector<int64_t> mn(n), mj(n);
    gcm_touchpoints(x, n, mn);
    lcm_touchpoints(x, n, mj);

    int low = 0, high = n - 1;
    double dip = 1.0;

    for (int iter = 0; iter < n + 8; ++iter) {
        std::vector<int> gcm, lcm;
        gcm.push_back(high);
        while (gcm.back() > low) gcm.push_back(int(mn[gcm.back()]));
        int l_gcm = int(gcm.size());
        lcm.push_back(low);
        while (lcm.back() < high) lcm.push_back(int(mj[lcm.back()]));
        int l_lcm = int(lcm.size());

        int ix = l_gcm - 2, iv = 1;
        int ig = l_gcm - 1, ih = l_lcm - 1;
        double d = 0.0;
        if (l_gcm != 2 || l_lcm != 2) {
            while (true) {
                int gcmix = gcm[ix], lcmiv = lcm[iv];
                if (gcmix > lcmiv) {
                    int gcmi1 = gcm[ix + 1];
                    double dx =
                        double(lcmiv - gcmi1 + 1) -
                        (x[lcmiv] - x[gcmi1]) * double(gcmix - gcmi1) /
                            (x[gcmix] - x[gcmi1]);
                    if (dx >= d) { d = dx; ig = ix + 1; ih = iv; }
                    ++iv;
                } else {
                    int lcmiv1 = lcm[iv - 1];
                    double dx = (x[gcmix] - x[lcmiv1]) *
                                    double(lcmiv - lcmiv1) /
                                    (x[lcmiv] - x[lcmiv1]) -
                                double(gcmix - lcmiv1 - 1);
                    if (dx >= d) { d = dx; ig = ix; ih = iv; }
                    --ix;
                }
                if (ix < 0) ix = 0;
                if (iv > l_lcm - 1) iv = l_lcm - 1;
                if (gcm[ix] == lcm[iv]) break;
            }
        } else {
            d = 1.0;
        }
        if (d < dip) break;

        double dip_l = 0.0;
        for (int j = ig; j < l_gcm - 1; ++j) {
            int jb = gcm[j + 1] + 1, je = gcm[j];
            double max_t = 1.0;
            if (je - jb > 1 && x[je] != x[jb]) {
                double slope = double(je - jb) / (x[je] - x[jb]);
                for (int jj = jb; jj <= je; ++jj) {
                    double t = double(jj - jb + 1) - (x[jj] - x[jb]) * slope;
                    if (t > max_t) max_t = t;
                }
            }
            dip_l = std::max(dip_l, max_t);
        }
        double dip_u = 0.0;
        for (int j = ih; j < l_lcm - 1; ++j) {
            int jb = lcm[j], je = lcm[j + 1] - 1;
            double max_t = 1.0;
            if (je - jb > 1 && x[je] != x[jb]) {
                double slope = double(je - jb) / (x[je] - x[jb]);
                for (int jj = jb; jj <= je; ++jj) {
                    double t = (x[jj] - x[jb]) * slope - double(jj - jb - 1);
                    if (t > max_t) max_t = t;
                }
            }
            dip_u = std::max(dip_u, max_t);
        }
        dip = std::max(dip, std::max(dip_l, dip_u));
        int new_low = gcm[ig], new_high = lcm[ih];
        if (new_low == low && new_high == high) break;
        low = new_low;
        high = new_high;
    }
    return dip / (2.0 * n);
}

}  // namespace

extern "C" {

// features: column-major not required — expects (n_features, n_samples)
// row-major (each row one feature's samples). Rows are sorted in place of a
// scratch copy. Output: dips[n_features].
void dip_statistics_batch(const double* features, int n_features,
                          int n_samples, double* dips) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int f = 0; f < n_features; ++f) {
        std::vector<double> buf(features + size_t(f) * n_samples,
                                features + size_t(f + 1) * n_samples);
        std::sort(buf.begin(), buf.end());
        dips[f] = dip_statistic_sorted(buf.data(), n_samples);
    }
}

}  // extern "C"
