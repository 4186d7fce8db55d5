// The host side of the staged copy up: the atoms a feature plan reads,
// copied out of a block of frames into a staging buffer (the pinned slot a
// chunk goes to the card from), frames split over OpenMP threads. Built by
// g++ at first use (deep_cartograph_torch/ops/build.py::load_host_library),
// bound with ctypes by deep_cartograph_torch/geom/kernels.py.

#include <cstdint>
#include <cstring>

static constexpr int kGrabFrames = 64;

extern "C" {

// src: (n_frames, n_atoms, 3) float32, C order. atoms: the n_sel atom
// indices to keep, in [0, n_atoms); null keeps every atom. dst: (n_frames,
// n_sel or n_atoms, 3) float32, C order. threads: the team (the caller sizes
// it to the block and to the cores it may take).
void stage_atoms(const float* src, int64_t n_frames, int64_t n_atoms,
                 const int64_t* atoms, int64_t n_sel, float* dst, int threads) {
    const int64_t width = atoms ? n_sel : n_atoms;
    // Frames are handed out kGrabFrames at a time, so a thread the system
    // preempts holds back one grab, not a share of the block.
#pragma omp parallel for schedule(dynamic, kGrabFrames) num_threads(threads) if (threads > 1)
    for (int64_t f = 0; f < n_frames; ++f) {
        const float* s = src + f * n_atoms * 3;
        float* d = dst + f * width * 3;
        if (!atoms) {
            std::memcpy(d, s, sizeof(float) * 3 * n_atoms);
            continue;
        }
        for (int64_t k = 0; k < n_sel; ++k) {
            const float* p = s + atoms[k] * 3;
            d[3 * k] = p[0];
            d[3 * k + 1] = p[1];
            d[3 * k + 2] = p[2];
        }
    }
}

}  // extern "C"
