// Fast COLVARS text I/O: parallel float parsing and formatting.
//
// The whole numeric body of a colvars file is parsed in one pass: the
// buffer splits at line boundaries across OpenMP threads, each thread
// strtof's its rows into the right output rows. Writing formats rows in
// parallel into per-thread buffers. Built by g++ at first use
// (deep_cartograph_torch/ops/build.py::load_host_library), bound with ctypes
// by deep_cartograph_torch/io/colvars.py.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Count data rows (non-empty, non-comment lines) and find body start.
long count_rows(const char* buf, long size, long* body_start) {
    long rows = 0;
    long i = 0;
    *body_start = -1;
    while (i < size) {
        // line start
        while (i < size && (buf[i] == ' ' || buf[i] == '\t')) ++i;
        bool is_comment = (i < size && buf[i] == '#');
        bool is_empty = (i < size && buf[i] == '\n');
        if (!is_comment && !is_empty && i < size) {
            if (*body_start < 0) *body_start = i;
            ++rows;
        }
        while (i < size && buf[i] != '\n') ++i;
        ++i;  // skip newline
    }
    return rows;
}

// Fast strtof for fixed-decimal tokens ("-12.3456"): when the digit string
// fits a < 2^24 mantissa with <= 10 fractional digits, float(mantissa) and
// float(10^d) are both EXACT in float32, so their correctly-rounded float32
// division equals strtof's correctly-rounded decimal conversion —
// byte-provable equality, ~5x faster. Anything else (exponents, long
// mantissas, inf/nan) falls back to strtof.
inline float fast_strtof(const char* p, char** end) {
    const char* s = p;
    while (*s == ' ' || *s == '\t') ++s;
    const char* tok = s;
    bool neg = false;
    if (*s == '-') { neg = true; ++s; }
    else if (*s == '+') ++s;
    uint32_t mant = 0;
    int digits = 0, frac = 0;
    while (*s >= '0' && *s <= '9') {
        mant = mant * 10u + uint32_t(*s - '0');
        ++digits; ++s;
        if (digits > 8) return strtof(tok, end);
    }
    if (*s == '.') {
        ++s;
        while (*s >= '0' && *s <= '9') {
            mant = mant * 10u + uint32_t(*s - '0');
            ++digits; ++frac; ++s;
            if (digits > 8) return strtof(tok, end);
        }
    }
    if (digits == 0 || mant >= (1u << 24) || *s == 'e' || *s == 'E' ||
        *s == 'x' || *s == 'X' || *s == '.')
        return strtof(tok, end);
    static const float POW10[11] = {1e0f, 1e1f, 1e2f, 1e3f, 1e4f, 1e5f,
                                    1e6f, 1e7f, 1e8f, 1e9f, 1e10f};
    float v = float(mant) / POW10[frac];
    *end = const_cast<char*>(s);
    return neg ? -v : v;
}

}  // namespace

extern "C" {

// Parse the numeric body of a colvars file into out[rows*cols] floats.
// Comment lines (starting with '#', e.g. the FIELDS header) are skipped.
// Returns the number of rows parsed, or -1 on a shape mismatch.
long colvars_parse(const char* buf, long size, long cols, float* out,
                   long max_rows) {
    long body_start;
    long rows = count_rows(buf, size, &body_start);
    if (rows > max_rows) return -1;
    if (rows == 0) return 0;

    // Collect the byte offset of each data line (sequential, cheap).
    std::vector<long> line_offsets;
    line_offsets.reserve(rows);
    long i = 0;
    while (i < size) {
        long start = i;
        while (start < size && (buf[start] == ' ' || buf[start] == '\t'))
            ++start;
        if (start < size && buf[start] != '#' && buf[start] != '\n') {
            line_offsets.push_back(start);
        }
        while (i < size && buf[i] != '\n') ++i;
        ++i;
    }

    long parsed_rows = (long)line_offsets.size();
    bool ok = true;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long r = 0; r < parsed_rows; ++r) {
        const char* p = buf + line_offsets[r];
        char* end;
        for (long c = 0; c < cols; ++c) {
            // Stop at end-of-line: strtof would skip '\n' and silently
            // consume the NEXT line's numbers for a short row, violating
            // the -1 shape-mismatch contract.
            const char* buf_end = buf + size;
            while (p < buf_end && (*p == ' ' || *p == '\t')) ++p;
            if (p >= buf_end || *p == '\n' || *p == '\r') {
#ifdef _OPENMP
#pragma omp atomic write
#endif
                ok = false;
                out[r * cols + c] = 0.0f;
                continue;
            }
            float v = fast_strtof(p, &end);
            if (end == p) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
                ok = false;
                v = 0.0f;
            }
            out[r * cols + c] = v;
            p = end;
        }
    }
    return ok ? parsed_rows : -1;
}

// Fast "%.Nf" for one float: fixed-point integer formatting (5-10x faster
// than snprintf's general decimal conversion). Exactness contract: output
// must match snprintf byte-for-byte — values whose scaled representation
// sits within floating-point error of a .5 rounding boundary (where the
// fast llround and printf's exact-decimal rounding could disagree), plus
// NaN/Inf/overflow, fall back to snprintf. Returns bytes written.
//
// `cap` bounds every write (incl. the snprintf fallback). Inputs come from
// float32 (|v| <= 3.4e38 -> <= 40 integer digits), so decimals + 48 always
// fits; callers size buffers with that per-value budget.
static inline int format_fixed(char* p, double v, int decimals,
                               double scale, const char* fmt, int cap) {
    if (!std::isfinite(v)) return snprintf(p, size_t(cap), fmt, v);
    double scaled = v * scale;
    if (std::fabs(scaled) >= 9.0e18) return snprintf(p, size_t(cap), fmt, v);
    // Boundary guard: exact-decimal rounding and scaled-double rounding can
    // disagree only when the exact product is ~0.5 mod 1 within the double
    // multiply's error (~1.1e-16 relative); 1e-14 relative gives a ~100x
    // margin while keeping the fast path for large-magnitude values (a
    // wider guard would route e.g. every 6-digit time stamp to snprintf).
    double frac = scaled - std::floor(scaled);
    double dist = std::fabs(frac - 0.5);
    if (dist < 1e-14 * std::fabs(scaled) + 1e-12)
        return snprintf(p, size_t(cap), fmt, v);
    long long n = std::llround(scaled);
    char* start = p;
    if (std::signbit(v)) *p++ = '-';
    unsigned long long mag = (unsigned long long)(n < 0 ? -n : n);
    unsigned long long ip = mag;
    unsigned long long fp = 0;
    unsigned long long pow10 = 1;
    for (int i = 0; i < decimals; ++i) pow10 *= 10ULL;
    if (decimals) { ip = mag / pow10; fp = mag % pow10; }
    // integer part
    char tmp[24];
    int ti = 0;
    do { tmp[ti++] = char('0' + ip % 10); ip /= 10; } while (ip);
    while (ti) *p++ = tmp[--ti];
    if (decimals) {
        *p++ = '.';
        for (int i = decimals - 1; i >= 0; --i) {
            p[i] = char('0' + fp % 10);
            fp /= 10;
        }
        p += decimals;
    }
    return int(p - start);
}

// Format rows*cols floats with `decimals` fixed decimals, space-separated,
// into per-thread buffers, then concatenate into `out` (caller-sized).
// When `roundtrip` is non-null it receives, per value, the float32 a
// reader will parse from the emitted text (the write-side half of the
// same-run colvars memory cache).
// Returns bytes written, or -1 if out_capacity is insufficient.
long colvars_format_rt(const float* data, long rows, long cols, int decimals,
                       char* out, long out_capacity, float* roundtrip) {
    int n_threads = 1;
#ifdef _OPENMP
    n_threads = omp_get_max_threads();
#endif
    if (n_threads == 1) {
        // Single thread: format straight into the caller's buffer — skips
        // a rows*cols*(decimals+16) intermediate allocation and the final
        // memcpy (~3 GB of traffic at 100k x 1k scale).
        const int budget = decimals + 48;  // worst-case token (see format_fixed)
        char* p = out;
        char* cap_end = out + out_capacity - (budget + 2);
        char fmt[16];
        snprintf(fmt, sizeof(fmt), "%%.%df", decimals);
        double scale = 1.0;
        for (int i = 0; i < decimals; ++i) scale *= 10.0;
        for (long r = 0; r < rows; ++r) {
            for (long c = 0; c < cols; ++c) {
                if (p >= cap_end) return -1;
                if (c) *p++ = ' ';
                char* tok = p;
                p += format_fixed(p, double(data[r * cols + c]), decimals,
                                  scale, fmt, budget);
                if (roundtrip) {
                    char* e;
                    *p = '\0';  // bound the token for the re-parse
                    roundtrip[r * cols + c] = fast_strtof(tok, &e);
                }
            }
            *p++ = '\n';
        }
        return long(p - out);
    }
    std::vector<std::vector<char>> buffers(n_threads);
    std::vector<long> lengths(n_threads, 0);
    long rows_per_thread = (rows + n_threads - 1) / n_threads;

#ifdef _OPENMP
#pragma omp parallel num_threads(n_threads)
#endif
    {
#ifdef _OPENMP
        int t = omp_get_thread_num();
#else
        int t = 0;
#endif
        long r0 = t * rows_per_thread;
        long r1 = std::min(rows, r0 + rows_per_thread);
        if (r0 < r1) {
            const int budget = decimals + 48;  // worst-case token incl.
                                               // snprintf fallback
            auto& buf = buffers[t];
            buf.resize(size_t(r1 - r0) * cols * size_t(budget + 2));
            char* p = buf.data();
            char fmt[16];
            snprintf(fmt, sizeof(fmt), "%%.%df", decimals);
            double scale = 1.0;
            for (int i = 0; i < decimals; ++i) scale *= 10.0;
            for (long r = r0; r < r1; ++r) {
                for (long c = 0; c < cols; ++c) {
                    if (c) *p++ = ' ';
                    char* tok = p;
                    p += format_fixed(p, double(data[r * cols + c]),
                                      decimals, scale, fmt, budget);
                    if (roundtrip) {
                        char* e;
                        *p = '\0';
                        roundtrip[r * cols + c] = fast_strtof(tok, &e);
                    }
                }
                *p++ = '\n';
            }
            lengths[t] = long(p - buf.data());
        }
    }

    long total = 0;
    for (int t = 0; t < n_threads; ++t) total += lengths[t];
    if (total > out_capacity) return -1;
    char* p = out;
    for (int t = 0; t < n_threads; ++t) {
        if (lengths[t]) {
            std::memcpy(p, buffers[t].data(), size_t(lengths[t]));
            p += lengths[t];
        }
    }
    return total;
}

// Back-compat symbol (no roundtrip output).
long colvars_format(const float* data, long rows, long cols, int decimals,
                    char* out, long out_capacity) {
    return colvars_format_rt(data, rows, cols, decimals, out, out_capacity,
                             nullptr);
}

}  // extern "C"
