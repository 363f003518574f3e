// Native host-side runtime: artefact codecs + reference-exact map update.
//
// The reference's heavy host-side work lives in C++ externals (Open3D IO,
// OpenCV imencode, Nav2 map_server, rosbag).  This library is the
// framework's native equivalent for the host paths that matter at
// production scale: PGM map encode/decode, NCLT velodyne binary unpacking,
// and the teach mapper's per-cell Bresenham log-odds update (the exact
// reference semantics of teach_run_depth_mapper._bresenham_mark, used both
// for fast host-side map building from recorded logs and as the golden
// reference the scatter-based JAX mapper is validated against).
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// PGM (P5) codec
// ---------------------------------------------------------------------------

// Parse a P5 PGM from `buf` (len bytes). Writes width/height to out params,
// pixel bytes to `out` (caller allocates >= max_out). Returns number of
// pixel bytes written, or -1 on parse error / overflow.
long pgm_decode(const uint8_t* buf, long len, uint8_t* out, long max_out,
                int* width, int* height) {
    long pos = 0;
    auto skip_ws_comments = [&]() {
        while (pos < len) {
            if (buf[pos] == '#') {
                while (pos < len && buf[pos] != '\n') pos++;
            } else if (isspace(buf[pos])) {
                pos++;
            } else {
                break;
            }
        }
    };
    auto read_int = [&]() -> long {
        skip_ws_comments();
        long v = 0;
        bool any = false;
        while (pos < len && buf[pos] >= '0' && buf[pos] <= '9') {
            v = v * 10 + (buf[pos] - '0');
            pos++;
            any = true;
        }
        return any ? v : -1;
    };

    if (len < 2 || buf[0] != 'P' || buf[1] != '5') return -1;
    pos = 2;
    long w = read_int();
    long h = read_int();
    long maxval = read_int();
    if (w <= 0 || h <= 0 || maxval <= 0 || maxval > 255) return -1;
    pos++;  // single whitespace after maxval
    long n = w * h;
    if (n > max_out || pos + n > len) return -1;
    std::memcpy(out, buf + pos, n);
    *width = (int)w;
    *height = (int)h;
    return n;
}

// Encode a P5 PGM into `out` (caller allocates >= pixels + 64).
// Returns bytes written.
long pgm_encode(const uint8_t* pixels, int width, int height, uint8_t* out,
                long max_out) {
    char header[64];
    int hlen = std::snprintf(header, sizeof(header), "P5\n%d %d\n255\n",
                             width, height);
    long n = (long)width * height;
    if (hlen + n > max_out) return -1;
    std::memcpy(out, header, hlen);
    std::memcpy(out + hlen, pixels, n);
    return hlen + n;
}

// ---------------------------------------------------------------------------
// NCLT velodyne binary unpack (x,y,z as u16 * 0.005 - 100, intensity byte)
// ---------------------------------------------------------------------------

long velodyne_unpack(const uint8_t* raw, long len, float* xyz,
                     float* intensity) {
    long n = len / 8;
    for (long i = 0; i < n; i++) {
        const uint8_t* r = raw + i * 8;
        for (int k = 0; k < 3; k++) {
            uint16_t v = (uint16_t)(r[2 * k] | (r[2 * k + 1] << 8));
            xyz[i * 3 + k] = v * 0.005f - 100.0f;
        }
        intensity[i] = (float)r[6];
    }
    return n;
}

// ---------------------------------------------------------------------------
// Reference-exact Bresenham log-odds update (teach_run_depth_mapper
// semantics: free cells along the ray at L_FREE, endpoint at L_OCC,
// clamped to [l_min, l_max])
// ---------------------------------------------------------------------------

void bresenham_update(float* grid, int rows, int cols, int r0, int c0,
                      const int* r1s, const int* c1s, long n_rays,
                      float l_free, float l_occ, float l_min, float l_max) {
    for (long i = 0; i < n_rays; i++) {
        int r1 = r1s[i], c1 = c1s[i];
        if (r1 < 0 || r1 >= rows || c1 < 0 || c1 >= cols) continue;
        int dr = std::abs(r1 - r0), dc = std::abs(c1 - c0);
        int sr = r0 < r1 ? 1 : -1, sc = c0 < c1 ? 1 : -1;
        int err = dr - dc;
        int r = r0, c = c0;
        while (true) {
            if (r < 0 || r >= rows || c < 0 || c >= cols) break;
            float* cell = grid + (long)r * cols + c;
            if (r == r1 && c == c1) {
                *cell = std::min(l_max, *cell + l_occ);
                break;
            }
            *cell = std::max(l_min, *cell + l_free);
            int e2 = 2 * err;
            if (e2 > -dc) { err -= dc; r += sr; }
            if (e2 < dr) { err += dr; c += sc; }
        }
    }
}

// ---------------------------------------------------------------------------
// Fast CSV float parser (trajectory/pose logs): parses `n_cols` floats per
// line, skipping a header line if it does not start with a digit/'-'.
// Returns rows parsed.
// ---------------------------------------------------------------------------

long csv_parse_floats(const char* buf, long len, double* out, long max_rows,
                      int n_cols) {
    long pos = 0, row = 0;
    while (pos < len && row < max_rows) {
        // skip non-numeric lines (headers, comments)
        char ch = buf[pos];
        if (!((ch >= '0' && ch <= '9') || ch == '-' || ch == '+' ||
              ch == '.')) {
            while (pos < len && buf[pos] != '\n') pos++;
            pos++;
            continue;
        }
        int col = 0;
        while (pos < len && col < n_cols) {
            char* end = nullptr;
            double v = std::strtod(buf + pos, &end);
            if (end == buf + pos) break;
            out[row * n_cols + col] = v;
            pos = end - buf;
            col++;
            if (pos < len && buf[pos] == ',') pos++;
        }
        while (pos < len && buf[pos] != '\n') pos++;
        pos++;
        if (col == n_cols) row++;
    }
    return row;
}

}  // extern "C"
