// Native host runtime of abnet3_torch: the host-side work of the port in
// C++, outside the CUDA kernels of csrc/:
//   - abnet3_cosine_distance: angular cosine distance matrix, float64
//     products of float32 frames
//   - abnet3_dtw: exact DTW + backtrace over a cost matrix
//   - abnet3_dtw_align: the two fused, the host loader backend's alignment
//   - abnet3_pad_batch: padded (B, T, d) batch assembly from a token table
//   - abnet3_parse_pairs: 7-column pair-file parser with string interning
//
// The reference delegated its host-side hot loops to native code
// (DTW_Cython, reference utils.py:147-153). The arithmetic here is the
// JAX package's native runtime's, so both hosts align the same frames.
//
// Plain C ABI, loaded via ctypes (abnet3_torch/native/__init__.py, which
// builds it at first use with: g++ -O3 -std=c++17 -shared -fPIC). No
// -march=native: with FMA the compiler may contract the float64 dot
// products, which moves the distances and flips near-ties of the DTW.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// Angular cosine distance matrix: out[i*n2+j] = arccos(cos(x_i, y_j))/pi,
// zero-norm rows at distance 1 from everything except other zero-norm
// rows (distance 0) — semantics of reference utils.py:40-60.
void abnet3_cosine_distance(const float* x, int n1, const float* y, int n2,
                            int d, double* out) {
    std::vector<double> nx(n1), ny(n2);
    for (int i = 0; i < n1; ++i) {
        double s = 0;
        for (int k = 0; k < d; ++k) s += (double)x[i * d + k] * x[i * d + k];
        nx[i] = std::sqrt(s);
    }
    for (int j = 0; j < n2; ++j) {
        double s = 0;
        for (int k = 0; k < d; ++k) s += (double)y[j * d + k] * y[j * d + k];
        ny[j] = std::sqrt(s);
    }
    const double pi = 3.14159265358979323846;
    for (int i = 0; i < n1; ++i) {
        for (int j = 0; j < n2; ++j) {
            double v;
            if (nx[i] == 0.0 && ny[j] == 0.0) {
                v = 0.0;
            } else if (nx[i] == 0.0 || ny[j] == 0.0) {
                v = 1.0;
            } else {
                double dot = 0;
                for (int k = 0; k < d; ++k)
                    dot += (double)x[i * d + k] * y[j * d + k];
                double c = dot / (nx[i] * ny[j]);
                c = std::max(-1.0, std::min(1.0, c));
                v = std::acos(c) / pi;
            }
            out[(size_t)i * n2 + j] = v;
        }
    }
}

// DTW with backtrace over a precomputed (n1 x n2) cost matrix.
// Steps {(1,0),(0,1),(1,1)}, diagonal-preferred ties (same convention as
// utils.dtw_numpy). Paths written in increasing order; returns path length
// (<= n1+n2-1), or -1 on error.
int abnet3_dtw(const double* dist, int n1, int n2, int32_t* out1,
               int32_t* out2, double* total_cost) {
    if (n1 <= 0 || n2 <= 0) return -1;
    std::vector<double> D((size_t)n1 * n2);
    D[0] = dist[0];
    for (int j = 1; j < n2; ++j) D[j] = D[j - 1] + dist[j];
    for (int i = 1; i < n1; ++i) {
        const double* c = dist + (size_t)i * n2;
        double* row = D.data() + (size_t)i * n2;
        const double* prev = row - n2;
        row[0] = prev[0] + c[0];
        for (int j = 1; j < n2; ++j) {
            double m = std::min(prev[j], std::min(prev[j - 1], row[j - 1]));
            row[j] = m + c[j];
        }
    }
    if (total_cost) *total_cost = D[(size_t)n1 * n2 - 1];
    // backtrace
    int i = n1 - 1, j = n2 - 1;
    std::vector<int32_t> p1, p2;
    p1.reserve(n1 + n2 - 1);
    p2.reserve(n1 + n2 - 1);
    p1.push_back(i);
    p2.push_back(j);
    while (i > 0 || j > 0) {
        if (i == 0) {
            --j;
        } else if (j == 0) {
            --i;
        } else {
            double diag = D[(size_t)(i - 1) * n2 + (j - 1)];
            double up = D[(size_t)(i - 1) * n2 + j];
            double left = D[(size_t)i * n2 + (j - 1)];
            if (diag <= up && diag <= left) {
                --i;
                --j;
            } else if (up <= left) {
                --i;
            } else {
                --j;
            }
        }
        p1.push_back(i);
        p2.push_back(j);
    }
    int L = (int)p1.size();
    for (int t = 0; t < L; ++t) {
        out1[t] = p1[L - 1 - t];
        out2[t] = p2[L - 1 - t];
    }
    return L;
}

// Fused: cosine distance + DTW alignment of two float32 feature matrices.
int abnet3_dtw_align(const float* f1, int n1, const float* f2, int n2,
                     int d, int32_t* out1, int32_t* out2) {
    std::vector<double> dist((size_t)n1 * n2);
    abnet3_cosine_distance(f1, n1, f2, n2, d, dist.data());
    return abnet3_dtw(dist.data(), n1, n2, out1, out2, nullptr);
}

// Assemble a zero-padded (B, T, d) batch from a row-major token table:
// out[b, :min(lens[b],T)] = table[offsets[b] : offsets[b]+...].
void abnet3_pad_batch(const float* table, const int64_t* offsets,
                      const int32_t* lens, int B, int T, int d,
                      float* out) {
    std::memset(out, 0, sizeof(float) * (size_t)B * T * d);
    for (int b = 0; b < B; ++b) {
        int n = std::min(lens[b], T);
        std::memcpy(out + (size_t)b * T * d,
                    table + (size_t)offsets[b] * d,
                    sizeof(float) * (size_t)n * d);
    }
}

// Parse a 7-column pair file buffer: "f1 s1 e1 f2 s2 e2 same|diff\n".
// File names are interned; ids + floats written to the output arrays
// (each sized max_pairs). The interned name table is emitted as a
// '\n'-separated buffer of capacity names_cap into names_out;
// *names_len receives its used size. Returns the number of pairs parsed,
// or -(1-based line number) of the first malformed line.
int64_t abnet3_parse_pairs(const char* buf, int64_t len, int64_t max_pairs,
                           int32_t* f1_id, double* s1, double* e1,
                           int32_t* f2_id, double* s2, double* e2,
                           int8_t* same, char* names_out,
                           int64_t names_cap, int64_t* names_len) {
    std::unordered_map<std::string, int32_t> intern;
    std::string names;
    int64_t count = 0;
    int64_t pos = 0;
    int64_t line_no = 0;

    // exactly ONE line terminator ('\n', '\r', or '\r\n' as a unit): the
    // main loop counts every line itself, so the -(line number) error
    // code stays exact across blank lines and CRLF files. Lone '\r'
    // endings are a documented leniency over the Python path (old-Mac
    // files), which only splits on '\n'.
    auto consume_eol = [&](int64_t& p) {
        if (p < len && buf[p] == '\r') {
            ++p;
            if (p < len && buf[p] == '\n') ++p;
        } else if (p < len && buf[p] == '\n') {
            ++p;
        }
    };
    // line.strip() whitespace (minus the terminators the line scan owns)
    auto is_ws = [](char c) {
        return c == ' ' || c == '\t' || c == '\v' || c == '\f';
    };
    auto intern_name = [&](const char* s, int64_t n) -> int32_t {
        std::string key(s, (size_t)n);
        auto it = intern.find(key);
        if (it != intern.end()) return it->second;
        int32_t id = (int32_t)intern.size();
        intern.emplace(std::move(key), id);
        names.append(s, (size_t)n);
        names.push_back('\n');
        return id;
    };
    // float()-parity numeric parse; strtod alone would diverge from the
    // pure-Python path three ways (the paths must agree): it reads a
    // corrupted column like 'abc' as 0.0 without an endptr check, it
    // accepts hex floats float() rejects, and it rejects the
    // between-digit underscores and surrounding whitespace float()
    // accepts inside a token.
    auto parse_num = [&](int64_t t0, int64_t t1, double* out) -> bool {
        while (t0 < t1 && is_ws(buf[t0])) ++t0;          // float(" x")
        while (t1 > t0 && is_ws(buf[t1 - 1])) --t1;      // float("x ")
        if (t0 == t1) return false;
        std::string s;
        s.reserve((size_t)(t1 - t0));
        for (int64_t i = t0; i < t1; ++i) {
            char c = buf[i];
            if (c == 'x' || c == 'X') return false;      // no hex floats
            if (c == '_') {                              // PEP 515: only
                if (i == t0 || i + 1 == t1) return false;  // between
                if (!std::isdigit((unsigned char)buf[i - 1]) ||
                    !std::isdigit((unsigned char)buf[i + 1])) return false;
                continue;                                // digits
            }
            s.push_back(c);
        }
        char* endp = nullptr;
        double v = strtod(s.c_str(), &endp);
        if (endp != s.c_str() + s.size()) return false;
        *out = v;
        return true;
    };

    // distinct sentinels for buffer-capacity failures (caller sizing
    // bugs) vs -(line number) for genuinely malformed content
    const int64_t kPairsOverflow = INT64_MIN + 1;
    const int64_t kNamesOverflow = INT64_MIN + 2;

    while (pos < len) {
        ++line_no;
        // one whole line: [pos, eol)
        int64_t eol = pos;
        while (eol < len && buf[eol] != '\n' && buf[eol] != '\r') ++eol;
        int64_t ls = pos, rs = eol;
        pos = eol;
        consume_eol(pos);
        // line.strip() both ends, then skip blank lines
        while (ls < rs && is_ws(buf[ls])) ++ls;
        while (rs > ls && is_ws(buf[rs - 1])) --rs;
        if (ls == rs) continue;
        if (count >= max_pairs) return kPairsOverflow;
        // split(" ") parity: tokens separated by EXACTLY one space, so a
        // space run yields an empty token and the 7-column check fails —
        // matching the reference's strip().split(" ") + len==7 contract
        // (reference utils.py:166-167). Tabs stay inside tokens, exactly
        // as split(" ") leaves them.
        int64_t t0s[7], t1s[7];
        int ntok = 0;
        for (int64_t p = ls; ; ) {
            int64_t t0 = p;
            while (p < rs && buf[p] != ' ') ++p;
            if (ntok == 7) return -line_no;  // 8th token: too many columns
            t0s[ntok] = t0;
            t1s[ntok] = p;
            ++ntok;
            if (p == rs) break;
            ++p;  // exactly one separator space
        }
        if (ntok != 7) return -line_no;
        // names may contain tabs; numeric columns get float() semantics
        f1_id[count] = intern_name(buf + t0s[0], t1s[0] - t0s[0]);
        if (!parse_num(t0s[1], t1s[1], &s1[count])) return -line_no;
        if (!parse_num(t0s[2], t1s[2], &e1[count])) return -line_no;
        f2_id[count] = intern_name(buf + t0s[3], t1s[3] - t0s[3]);
        if (!parse_num(t0s[4], t1s[4], &s2[count])) return -line_no;
        if (!parse_num(t0s[5], t1s[5], &e2[count])) return -line_no;
        int64_t tl = t1s[6] - t0s[6];
        if (tl == 4 && std::strncmp(buf + t0s[6], "same", 4) == 0) {
            same[count] = 1;
        } else if (tl == 4 && std::strncmp(buf + t0s[6], "diff", 4) == 0) {
            same[count] = -1;
        } else {
            return -line_no;
        }
        ++count;
    }
    if ((int64_t)names.size() > names_cap) return kNamesOverflow;
    std::memcpy(names_out, names.data(), names.size());
    *names_len = (int64_t)names.size();
    return count;
}

}  // extern "C"
