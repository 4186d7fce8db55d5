// The host side of the staged copies: the atoms a feature plan reads,
// copied out of a block of frames into a staging buffer (the pinned slot a
// chunk goes to the card from), frames split over OpenMP threads; and the
// rows of a chunk's features copied out of the pinned slot they came down
// to, into a matrix whose pages are mapped ahead of them. Built by g++ at
// first use (deep_cartograph_torch/ops/build.py::load_host_library), bound
// with ctypes by deep_cartograph_torch/geom/kernels.py.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <sys/mman.h>
#include <unistd.h>

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

// dst <- src, n floats each, neither overlapping the other, split into one
// contiguous block a thread.
void copy_floats(const float* src, float* dst, int64_t n, int threads) {
    if (threads < 1) threads = 1;
#pragma omp parallel for schedule(static, 1) num_threads(threads) if (threads > 1)
    for (int t = 0; t < threads; ++t) {
        const int64_t a = n * t / threads;
        const int64_t b = n * (t + 1) / threads;
        std::memcpy(dst + a, src + a, sizeof(float) * (b - a));
    }
}

// Replace the pages of [p, p + n_bytes), rounded out to whole pages, by
// fresh zero pages mapped now (mmap MAP_FIXED | MAP_POPULATE over the
// caller's own private anonymous mapping), so that the copies into them take
// no page faults. What the pages held is lost. Returns 0, EINVAL for a p
// off a page boundary, or the errno of a refused mmap.
int map_pages(void* p, int64_t n_bytes) {
    const uintptr_t page = static_cast<uintptr_t>(sysconf(_SC_PAGESIZE));
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if (a % page != 0 || n_bytes < 0) return EINVAL;
    const size_t len = (static_cast<uintptr_t>(n_bytes) + page - 1) / page * page;
    if (len == 0) return 0;
    void* got = mmap(p, len, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS | MAP_FIXED | MAP_POPULATE, -1, 0);
    return got == MAP_FAILED ? errno : 0;
}

}  // extern "C"
