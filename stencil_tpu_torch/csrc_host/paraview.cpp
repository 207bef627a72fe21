// CSV row writer of DistributedDomain.write_paraview (the port's own copy of
// the JAX package's native/paraview.cpp).
//
// The reference writes its paraview dumps from C++ (src/stencil.cu:1188-1264);
// a Python row loop is O(cells) interpreter work, minutes at flagship sizes,
// where this writer streams ~10^8 rows in seconds. Built by g++ into a shared
// library on first use (ops/_native.build_host) and called through ctypes;
// float formatting is std::to_chars shortest round-trip, normalized to
// Python's repr() ("2" -> "2.0"), so the writer and the plain Python loop
// (utils/paraview.write_plain) emit byte-identical files.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Append v formatted EXACTLY like Python's repr(float): shortest
// round-trip digits, fixed notation iff the decimal exponent E is in
// [-4, 16), else scientific with a signed >=2-digit exponent. (A plain
// std::to_chars general format picks fixed-vs-scientific by string
// length instead — 0.0001 would become "1e-04".)
inline char *fmt_double(char *p, double v) {
    if (std::isnan(v)) {
        std::memcpy(p, "nan", 3);
        return p + 3;
    }
    if (std::isinf(v)) {
        if (v < 0) *p++ = '-';
        std::memcpy(p, "inf", 3);
        return p + 3;
    }
    if (std::signbit(v)) {
        *p++ = '-';
        v = -v;
    }
    char buf[48];  // shortest scientific: "d[.ddd]e±dd"
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
    const char *end =
        std::to_chars(buf, buf + sizeof buf, v, std::chars_format::scientific)
            .ptr;
#else
    // libstdc++ < GCC 11 ships integer-only to_chars. Shortest round-trip
    // by precision search instead: %.*e rounds to the CLOSEST (p+1)-digit
    // scientific string, so the first precision whose strtod round-trips
    // is exactly the shortest-round-trip digit string to_chars picks.
    int len = 0;
    for (int prec = 0; prec <= 17; ++prec) {
        len = std::snprintf(buf, sizeof buf, "%.*e", prec, v);
        if (std::strtod(buf, nullptr) == v) break;
    }
    const char *end = buf + len;
#endif
    char digits[40];
    int nd = 0;
    const char *q = buf;
    digits[nd++] = *q++;
    // ',' too: the snprintf fallback is locale-dependent where to_chars
    // is not, and a comma-decimal LC_NUMERIC must not corrupt the scan
    if (*q == '.' || *q == ',') {
        ++q;
        while (*q != 'e') digits[nd++] = *q++;
    }
    ++q;  // 'e'
    const int esign = (*q == '-') ? -1 : 1;
    ++q;
    int E = 0;
    while (q < end) E = E * 10 + (*q++ - '0');
    E *= esign;
    if (E >= -4 && E < 16) {  // fixed
        if (E >= nd - 1) {
            for (int i = 0; i < nd; ++i) *p++ = digits[i];
            for (int i = nd - 1; i < E; ++i) *p++ = '0';
            *p++ = '.';
            *p++ = '0';
        } else if (E >= 0) {
            for (int i = 0; i <= E; ++i) *p++ = digits[i];
            *p++ = '.';
            for (int i = E + 1; i < nd; ++i) *p++ = digits[i];
        } else {
            *p++ = '0';
            *p++ = '.';
            for (int i = 0; i < -E - 1; ++i) *p++ = '0';
            for (int i = 0; i < nd; ++i) *p++ = digits[i];
        }
    } else {  // scientific, Python style
        *p++ = digits[0];
        if (nd > 1) {
            *p++ = '.';
            for (int i = 1; i < nd; ++i) *p++ = digits[i];
        }
        *p++ = 'e';
        *p++ = (E < 0) ? '-' : '+';
        int a = (E < 0) ? -E : E;
        char eb[8];
        int ne = 0;
        while (a) {
            eb[ne++] = char('0' + a % 10);
            a /= 10;
        }
        while (ne < 2) eb[ne++] = '0';
        while (ne) *p++ = eb[--ne];
    }
    return p;
}

inline char *fmt_long(char *p, int64_t v) {
    auto res = std::to_chars(p, p + 24, v);
    return res.ptr;
}

}  // namespace

extern "C" int stencil_paraview_write(
    const char *path, const char *header,
    int64_t oz, int64_t oy, int64_t ox,   // block's global origin (z, y, x)
    int64_t sz, int64_t sy, int64_t sx,   // interior extent
    int nq, const double *const *qs) {    // nq dense [sz, sy, sx] arrays
    FILE *f = std::fopen(path, "w");
    if (!f) return -1;
    std::vector<char> iobuf(size_t(1) << 20);
    std::setvbuf(f, iobuf.data(), _IOFBF, iobuf.size());
    std::fputs(header, f);
    std::fputc('\n', f);
    // worst case per row: 3 int64 + nq doubles + separators
    std::vector<char> line(size_t(80) + size_t(nq) * 40);
    for (int64_t z = 0; z < sz; ++z) {
        for (int64_t y = 0; y < sy; ++y) {
            const int64_t row0 = (z * sy + y) * sx;
            for (int64_t x = 0; x < sx; ++x) {
                char *p = line.data();
                p = fmt_long(p, oz + z);
                *p++ = ',';
                p = fmt_long(p, oy + y);
                *p++ = ',';
                p = fmt_long(p, ox + x);
                for (int q = 0; q < nq; ++q) {
                    *p++ = ',';
                    p = fmt_double(p, qs[q][row0 + x]);
                }
                *p++ = '\n';
                if (std::fwrite(line.data(), 1, size_t(p - line.data()), f)
                    != size_t(p - line.data())) {
                    std::fclose(f);
                    return -2;
                }
            }
        }
    }
    return std::fclose(f) == 0 ? 0 : -3;
}
