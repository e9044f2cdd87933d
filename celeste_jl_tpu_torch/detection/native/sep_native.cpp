// Native detection kernels — the TPU-era counterpart of the reference's
// libsep C dependency (deps/build.jl builds kbarbary/sep; src/SEP.jl wraps
// it). Host-side image segmentation is latency-sensitive in the survey
// pipeline, so the hot pieces (connected-component labeling, background
// cell statistics) are C++ with a C ABI consumed via ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC sep_native.cpp -o libsepnative.so

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>

extern "C" {

// Union-find with path halving.
static inline int32_t uf_find(std::vector<int32_t> &parent, int32_t i) {
    while (parent[i] != i) {
        parent[i] = parent[parent[i]];
        i = parent[i];
    }
    return i;
}

static inline void uf_union(std::vector<int32_t> &parent, int32_t a, int32_t b) {
    int32_t ra = uf_find(parent, a), rb = uf_find(parent, b);
    if (ra != rb) parent[std::max(ra, rb)] = std::min(ra, rb);
}

// 8-connected component labeling of a binary mask (H x W, row-major).
// labels[i] in {0 = background, 1..n}. Returns n.
int32_t cc_label_8(const uint8_t *mask, int64_t H, int64_t W,
                   int32_t *labels) {
    std::vector<int32_t> parent;
    parent.reserve(1024);
    parent.push_back(0);  // background sentinel

    // First pass: provisional labels + equivalences.
    for (int64_t i = 0; i < H; ++i) {
        for (int64_t j = 0; j < W; ++j) {
            const int64_t idx = i * W + j;
            if (!mask[idx]) { labels[idx] = 0; continue; }
            // neighbors already visited: W, NW, N, NE
            int32_t neigh[4];
            int n_neigh = 0;
            if (j > 0 && labels[idx - 1]) neigh[n_neigh++] = labels[idx - 1];
            if (i > 0) {
                const int64_t up = idx - W;
                if (j > 0 && labels[up - 1]) neigh[n_neigh++] = labels[up - 1];
                if (labels[up]) neigh[n_neigh++] = labels[up];
                if (j + 1 < W && labels[up + 1]) neigh[n_neigh++] = labels[up + 1];
            }
            if (n_neigh == 0) {
                int32_t lab = (int32_t)parent.size();
                parent.push_back(lab);
                labels[idx] = lab;
            } else {
                int32_t m = neigh[0];
                for (int k = 1; k < n_neigh; ++k) m = std::min(m, neigh[k]);
                labels[idx] = m;
                for (int k = 0; k < n_neigh; ++k)
                    uf_union(parent, m, neigh[k]);
            }
        }
    }

    // Flatten + renumber.
    std::vector<int32_t> remap(parent.size(), 0);
    int32_t next = 0;
    for (size_t i = 1; i < parent.size(); ++i) {
        int32_t root = uf_find(parent, (int32_t)i);
        if (remap[root] == 0 && root == (int32_t)i) remap[root] = ++next;
    }
    // roots may appear later than first use; second sweep assigns children
    for (size_t i = 1; i < parent.size(); ++i) {
        int32_t root = uf_find(parent, (int32_t)i);
        if (remap[root] == 0) remap[root] = ++next;
        remap[i] = remap[root];
    }
    for (int64_t idx = 0; idx < H * W; ++idx)
        if (labels[idx]) labels[idx] = remap[labels[idx]];
    return next;
}

// Sigma-clipped cell statistics for the background mesh: for each cell,
// iteratively clip at `sigclip` sigma and emit the SExtractor mode
// estimator and the clipped RMS.
void background_cells(const double *data, int64_t H, int64_t W,
                      int64_t bh, int64_t bw, double sigclip, int maxiter,
                      double *mesh_back, double *mesh_rms) {
    const int64_t nh = (H + bh - 1) / bh, nw = (W + bw - 1) / bw;
    std::vector<double> vals;
    for (int64_t ci = 0; ci < nh; ++ci) {
        for (int64_t cj = 0; cj < nw; ++cj) {
            vals.clear();
            const int64_t i1 = std::min(H, (ci + 1) * bh);
            const int64_t j1 = std::min(W, (cj + 1) * bw);
            for (int64_t i = ci * bh; i < i1; ++i)
                for (int64_t j = cj * bw; j < j1; ++j) {
                    double v = data[i * W + j];
                    if (std::isfinite(v)) vals.push_back(v);
                }
            const int64_t cell = ci * nw + cj;
            if (vals.empty()) { mesh_back[cell] = 0; mesh_rms[cell] = 0; continue; }
            double med = 0, mean = 0, sd = 0;
            for (int it = 0; it < maxiter; ++it) {
                std::nth_element(vals.begin(), vals.begin() + vals.size() / 2,
                                 vals.end());
                med = vals[vals.size() / 2];
                if (vals.size() % 2 == 0) {
                    double lo = *std::max_element(vals.begin(),
                                                  vals.begin() + vals.size() / 2);
                    med = 0.5 * (med + lo);
                }
                mean = 0;
                for (double v : vals) mean += v;
                mean /= vals.size();
                sd = 0;
                for (double v : vals) sd += (v - mean) * (v - mean);
                sd = std::sqrt(sd / vals.size());
                if (sd == 0) break;
                size_t kept = 0;
                for (size_t k = 0; k < vals.size(); ++k)
                    if (std::fabs(vals[k] - med) < sigclip * sd)
                        vals[kept++] = vals[k];
                if (kept == vals.size()) break;
                vals.resize(kept);
            }
            double mode = (sd > 0 && std::fabs(mean - med) / sd < 0.3)
                              ? 2.5 * med - 1.5 * mean : med;
            mesh_back[cell] = mode;
            mesh_rms[cell] = sd;
        }
    }
}

}  // extern "C"
