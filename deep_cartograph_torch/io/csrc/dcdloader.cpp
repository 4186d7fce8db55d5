// Prefetching DCD chunk loader: decodes trajectory chunks on a background
// thread so host decode overlaps device compute and upload.
//
// Format handled: CHARMM/NAMD DCD (Fortran record framing, optional
// per-frame 64-byte unit-cell record, X/Y/Z float32 records). Little-endian
// files only: deep_cartograph_torch/io/dcd.py reads big-endian files with
// its numpy slice reader, chosen from the header before dcd_open.
//
// API (ctypes):
//   handle = dcd_open(path, chunk_frames, prefetch_depth)
//   n      = dcd_next_chunk(handle, out)   // out: chunk*atoms*3 f32,
//                                          // (frame, atom, xyz); 0 = EOF,
//                                          // negative = error
//   dcd_natoms(handle) / dcd_nframes(handle)
//   dcd_close(handle)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Chunk {
    std::vector<float> data;  // (frames, atoms, 3)
    int n_frames = 0;
};

struct DcdReader {
    FILE* fh = nullptr;
    int n_atoms = 0;
    int n_frames = 0;
    bool has_cell = false;
    long header_size = 0;
    long frame_bytes = 0;
    int chunk_frames = 0;
    int next_frame = 0;

    std::thread worker;
    std::mutex mu;
    std::condition_variable cv_produce, cv_consume;
    std::deque<Chunk> queue;
    size_t depth = 2;
    bool done = false;
    bool stop = false;
    int error = 0;
};

bool read_exact(FILE* fh, void* buf, size_t n) {
    return fread(buf, 1, n, fh) == n;
}

// Parse the three header records; little-endian only.
bool parse_header(DcdReader* r) {
    int32_t marker = 0;
    if (!read_exact(r->fh, &marker, 4) || marker != 84) return false;
    char tag[4];
    if (!read_exact(r->fh, tag, 4) || std::memcmp(tag, "CORD", 4) != 0)
        return false;
    int32_t icntrl[20];
    if (!read_exact(r->fh, icntrl, 80)) return false;
    int32_t end1;
    if (!read_exact(r->fh, &end1, 4) || end1 != 84) return false;

    int32_t tlen;
    if (!read_exact(r->fh, &tlen, 4)) return false;
    if (fseek(r->fh, tlen, SEEK_CUR) != 0) return false;
    int32_t tend;
    if (!read_exact(r->fh, &tend, 4) || tend != tlen) return false;

    int32_t alen, natoms, aend;
    if (!read_exact(r->fh, &alen, 4) || alen != 4) return false;
    if (!read_exact(r->fh, &natoms, 4)) return false;
    if (!read_exact(r->fh, &aend, 4) || aend != 4) return false;
    // Corrupt/crafted headers: a negative or absurd atom count would feed
    // a huge size_t into the worker thread's resize (std::terminate via
    // uncaught bad_alloc) instead of a clean open failure.
    if (natoms <= 0 || natoms > 100'000'000) return false;

    r->n_atoms = natoms;
    r->n_frames = icntrl[0];
    r->has_cell = icntrl[10] != 0;
    r->header_size = ftell(r->fh);
    long coord_rec = 4 + 4L * natoms + 4;
    r->frame_bytes = (r->has_cell ? 4 + 48 + 4 : 0) + 3 * coord_rec;

    if (r->n_frames <= 0) {
        // Header frame count is unreliable in some writers: derive from size.
        fseek(r->fh, 0, SEEK_END);
        long total = ftell(r->fh);
        r->n_frames = (int)((total - r->header_size) / r->frame_bytes);
        fseek(r->fh, r->header_size, SEEK_SET);
    }
    return true;
}

// Bytes read by one fread: whole frames, at least one.
constexpr long kSlabBytes = 1L << 20;

// Decode up to chunk_frames frames starting at next_frame into chunk,
// reading whole frames a slab at a time and checking each record's markers.
bool decode_chunk(DcdReader* r, Chunk* chunk) {
    int remaining = r->n_frames - r->next_frame;
    int n = remaining < r->chunk_frames ? remaining : r->chunk_frames;
    if (n <= 0) return false;
    const int A = r->n_atoms;
    const long rec = 4L * A;
    const long cell = r->has_cell ? 56 : 0;
    chunk->data.resize((size_t)n * A * 3);
    chunk->n_frames = n;
    long base = r->header_size + (long)r->next_frame * r->frame_bytes;
    if (fseek(r->fh, base, SEEK_SET) != 0) { r->error = -2; return false; }
    long slab_frames = kSlabBytes / r->frame_bytes;
    if (slab_frames < 1) slab_frames = 1;
    std::vector<unsigned char> slab;
    for (int f0 = 0; f0 < n; f0 += (int)slab_frames) {
        int m = n - f0 < slab_frames ? n - f0 : (int)slab_frames;
        slab.resize((size_t)m * r->frame_bytes);
        if (!read_exact(r->fh, slab.data(), slab.size())) {
            r->error = -3; return false;
        }
        for (int f = 0; f < m; ++f) {
            const unsigned char* p = slab.data() + (size_t)f * r->frame_bytes + cell;
            float* out = chunk->data.data() + (size_t)(f0 + f) * A * 3;
            for (int d = 0; d < 3; ++d) {
                int32_t len, end;
                std::memcpy(&len, p, 4);
                std::memcpy(&end, p + 4 + rec, 4);
                if (len != rec || end != len) { r->error = -3; return false; }
                // deinterleave: axis-major record -> (atom, xyz) layout
                const unsigned char* axis = p + 4;
                for (int a = 0; a < A; ++a)
                    std::memcpy(out + a * 3 + d, axis + 4L * a, 4);
                p += 8 + rec;
            }
        }
    }
    r->next_frame += n;
    return true;
}

void prefetch_loop(DcdReader* r) {
    for (;;) {
        Chunk chunk;
        bool ok = decode_chunk(r, &chunk);
        std::unique_lock<std::mutex> lock(r->mu);
        if (!ok) {
            r->done = true;
            r->cv_consume.notify_all();
            return;
        }
        r->cv_produce.wait(lock, [r] {
            return r->queue.size() < r->depth || r->stop;
        });
        if (r->stop) return;
        r->queue.push_back(std::move(chunk));
        r->cv_consume.notify_one();
    }
}

}  // namespace

extern "C" {

void* dcd_open(const char* path, int chunk_frames, int prefetch_depth) {
    auto* r = new DcdReader();
    r->fh = fopen(path, "rb");
    if (!r->fh) { delete r; return nullptr; }
    if (!parse_header(r)) { fclose(r->fh); delete r; return nullptr; }
    r->chunk_frames = chunk_frames > 0 ? chunk_frames : 2048;
    r->depth = prefetch_depth > 0 ? (size_t)prefetch_depth : 2;
    r->worker = std::thread(prefetch_loop, r);
    return r;
}

int dcd_natoms(void* handle) { return ((DcdReader*)handle)->n_atoms; }
int dcd_nframes(void* handle) { return ((DcdReader*)handle)->n_frames; }

// Copy the next decoded chunk into out (capacity chunk_frames*natoms*3).
// Returns frames copied; 0 at end of trajectory; <0 on decode error.
int dcd_next_chunk(void* handle, float* out) {
    auto* r = (DcdReader*)handle;
    std::unique_lock<std::mutex> lock(r->mu);
    r->cv_consume.wait(lock, [r] { return !r->queue.empty() || r->done; });
    if (r->queue.empty()) return r->error;  // 0 on clean EOF
    Chunk chunk = std::move(r->queue.front());
    r->queue.pop_front();
    r->cv_produce.notify_one();
    lock.unlock();
    std::memcpy(out, chunk.data.data(), chunk.data.size() * sizeof(float));
    return chunk.n_frames;
}

void dcd_close(void* handle) {
    auto* r = (DcdReader*)handle;
    {
        std::lock_guard<std::mutex> lock(r->mu);
        r->stop = true;
    }
    r->cv_produce.notify_all();
    if (r->worker.joinable()) r->worker.join();
    if (r->fh) fclose(r->fh);
    delete r;
}

}  // extern "C"
