// Fast whitespace-separated numeric parsing for the legacy-VTK ASCII reader.
//
// The PyTorch port's copy of native/fast_parse.cpp (same C ABI and code):
// the numeric payloads of pyfocusr_tpu_torch/io/vtk_io.py's ASCII reader,
// built by pyfocusr_tpu_torch/native.py and loaded with ctypes.

#include <cstdint>
#include <cstdlib>

extern "C" {

// Parse up to max_out whitespace-separated doubles from buf[0:len).
// Returns the number parsed; *consumed gets the byte offset after the last
// parsed token (so callers can resume section-by-section).
int64_t parse_doubles(const char* buf, int64_t len, double* out,
                      int64_t max_out, int64_t* consumed) {
    const char* p = buf;
    const char* end = buf + len;
    int64_t n = 0;
    while (n < max_out) {
        // strtod skips leading whitespace itself, but stop at 'end'.
        while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
            ++p;
        if (p >= end) break;
        char* next = nullptr;
        double val = std::strtod(p, &next);
        if (next == p) break;  // non-numeric token
        out[n++] = val;
        p = next;
    }
    if (consumed) *consumed = p - buf;
    return n;
}

// Same for int64 connectivity streams.
int64_t parse_longs(const char* buf, int64_t len, int64_t* out,
                    int64_t max_out, int64_t* consumed) {
    const char* p = buf;
    const char* end = buf + len;
    int64_t n = 0;
    while (n < max_out) {
        while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
            ++p;
        if (p >= end) break;
        char* next = nullptr;
        long long val = std::strtoll(p, &next, 10);
        if (next == p) break;
        out[n++] = (int64_t)val;
        p = next;
    }
    if (consumed) *consumed = p - buf;
    return n;
}

}  // extern "C"
