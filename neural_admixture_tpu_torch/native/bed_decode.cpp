// Native host-side genotype kernels (C++17, std::thread work pool).
//
// A copy of the JAX package's native/bed_decode.cpp, code unchanged, built
// into this package's own library (native/build.py): the readers decode
// BED bytes and PGEN records on the host, straight into the sample-major
// 2-bit packed rows that the card's kernels read, and the dense
// log-likelihood runs here too. Each entry point has a NumPy twin in the
// port's Python modules, which is its oracle in the tests.
//
// Parallelism is a plain std::thread + atomic work-stealing chunk pool
// rather than OpenMP: identical throughput for these memory-bound loops and
// no libgomp dependency.
//
// Layouts:
//   bed:    SNP-major, (M, nbytes) with nbytes = ceil(N/4); 2-bit PLINK
//           codes per sample, little-endian within each byte.
//   geno:   sample-major dosages, (N, M) uint8, 3 = missing.
//   packed: sample-major 2-bit dosages, (N, W) uint8, W = m_pad/4; genotype
//           j of a row lives at bits [2*(j%4)] of byte j/4; padding columns
//           (>= M) are genotype 0.
//
// Build: g++ -O3 -march=native -pthread -shared -fPIC (see build.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

static const uint8_t LUT[4] = {2, 3, 1, 0};  // PLINK code -> dosage

namespace {

unsigned pool_size() {
    unsigned hw = std::thread::hardware_concurrency();
    return hw ? hw : 4;
}

// Run fn(begin, end) over [0, total) in dynamic chunks on a thread pool.
template <typename F>
void parallel_chunks(int64_t total, int64_t chunk, F&& fn) {
    const unsigned n_threads =
        static_cast<unsigned>(std::min<int64_t>(pool_size(),
                                                (total + chunk - 1) / chunk));
    if (n_threads <= 1) {
        if (total > 0) fn(static_cast<int64_t>(0), total);
        return;
    }
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
        while (true) {
            const int64_t begin = next.fetch_add(chunk);
            if (begin >= total) break;
            fn(begin, std::min(begin + chunk, total));
        }
    };
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (unsigned t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// Decode BED bytes to a dense (N, M) dosage matrix.
// Cache-blocked transpose; parallel over sample blocks (disjoint rows).
void na_decode_bed(const uint8_t* bed, int64_t M, int64_t nbytes, int64_t N,
                   uint8_t* geno) {
    const int64_t MT = 1024, NT = 4096;
    parallel_chunks(N, NT, [=](int64_t n0, int64_t n1) {
        for (int64_t m0 = 0; m0 < M; m0 += MT) {
            const int64_t m1 = std::min(m0 + MT, M);
            for (int64_t m = m0; m < m1; ++m) {
                const uint8_t* brow = bed + m * nbytes;
                for (int64_t n = n0; n < n1; ++n) {
                    const uint8_t code = (brow[n >> 2] >> (2 * (n & 3))) & 3;
                    geno[n * M + m] = LUT[code];
                }
            }
        }
    });
}

// Decode BED bytes straight into the sample-major 2-bit packed layout,
// never materializing the (N, M) uint8 matrix. Output must be zeroed
// (padding columns stay genotype 0). W = output row width in bytes.
void na_bed_to_packed(const uint8_t* bed, int64_t M, int64_t nbytes,
                      int64_t N, int64_t W, uint8_t* packed) {
    const int64_t MT = 2048, NT = 4096;
    parallel_chunks(N, NT, [=](int64_t n0, int64_t n1) {
        for (int64_t m0 = 0; m0 < M; m0 += MT) {
            const int64_t m1 = std::min(m0 + MT, M);
            for (int64_t m = m0; m < m1; ++m) {
                const uint8_t* brow = bed + m * nbytes;
                const int64_t ob = m >> 2;
                const int shift = 2 * (m & 3);
                for (int64_t n = n0; n < n1; ++n) {
                    const uint8_t code = (brow[n >> 2] >> (2 * (n & 3))) & 3;
                    packed[n * W + ob] |=
                        static_cast<uint8_t>(LUT[code] << shift);
                }
            }
        }
    });
}

// Pack a dense (N, M) dosage matrix into (N, W) 2-bit rows (W >= ceil(M/4);
// output must be zeroed).
void na_pack_2bit(const uint8_t* geno, int64_t N, int64_t M, int64_t W,
                  uint8_t* packed) {
    parallel_chunks(N, 256, [=](int64_t n0, int64_t n1) {
        for (int64_t n = n0; n < n1; ++n) {
            const uint8_t* grow = geno + n * M;
            uint8_t* prow = packed + n * W;
            for (int64_t m = 0; m < M; ++m) {
                prow[m >> 2] |=
                    static_cast<uint8_t>((grow[m] & 3) << (2 * (m & 3)));
            }
        }
    });
}

// Masked binomial log-likelihood, double precision, per-chunk partials
// combined under a mutex-free atomic scheme (each chunk adds to its own
// slot) -- the semantics of ops/loglikelihood.py's host formula.
// G: (N, M) uint8; P: (M, K) double; Q: (N, K) double.
double na_loglikelihood(const uint8_t* G, const double* P, const double* Q,
                        int64_t N, int64_t M, int64_t K, double eps) {
    const int64_t MT = 256;
    const int64_t n_chunks = (M + MT - 1) / MT;
    std::vector<double> partials(static_cast<size_t>(n_chunks), 0.0);
    parallel_chunks(M, MT, [&, G, P, Q, N, M, K, eps](int64_t j0, int64_t j1) {
        double local = 0.0;
        for (int64_t j = j0; j < j1; ++j) {
            const double* p = P + j * K;
            for (int64_t i = 0; i < N; ++i) {
                const uint8_t g = G[i * M + j];
                if (g != 3) {
                    const double* q = Q + i * K;
                    double rec = 0.0;
                    for (int64_t k = 0; k < K; ++k) rec += q[k] * p[k];
                    rec = std::max(eps, std::min(rec, 1.0 - eps));
                    double gd = static_cast<double>(g);
                    gd = std::max(eps, std::min(gd, 2.0 - eps));
                    local += gd * std::log(rec) + (2.0 - gd) * std::log1p(-rec);
                }
            }
        }
        partials[static_cast<size_t>(j0 / MT)] = local;
    });
    double logl = 0.0;
    for (double v : partials) logl += v;
    return logl;
}

}  // extern "C"

// ------------- PGEN standard-mode (0x10/0x11) record decoder ----------------
//
// Hot inner loop of io/pgen_standard.py's pure-Python reader (same spec
// model -- see that module's layout summary; the two implementations are
// pinned bit-identical, and fuzzed to agree on accept-vs-reject, by
// tests/test_torch_port_readers.py).
// Sequential by necessity: LD-compressed records (vrtype & 7 in {2, 3})
// patch the most recent non-LD variant's genotypes.
//
// vrtype & 7: 0 plain 2-bit; 1 onebit (header byte C: low value C >> 2,
// second value (C >> 2) + (C & 3), then ceil(N/8) bitarray, then a
// difflist of exceptions); 2 LD difflist; 3 inverted-LD difflist;
// 4..7 difflist against the constant genotype (vrtype & 3). High vrtype
// bits flag appended aux tracks (skipped); with no high bit set the main
// track must consume the record exactly. Validation matches the Python
// path: strictly increasing in-bounds difflist sample ids, bounds on
// every read, rc < 0 on any violation (never crash).

namespace {

// LEB128 vint at rec[*p]; 0 on success, -2 on overrun/overflow.
inline int read_vint(const uint8_t* rec, int64_t len, int64_t* p,
                     int64_t* val) {
    int64_t v = 0;
    int shift = 0;
    while (true) {
        if (*p >= len) return -2;
        const uint8_t b = rec[(*p)++];
        v |= static_cast<int64_t>(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
        if (shift > 56) return -2;
    }
    *val = v;
    return 0;
}

// Difflist at rec[*p] -> (ids, vals, count); buffers sized >= N.
int parse_difflist(const uint8_t* rec, int64_t len, int64_t* p, int64_t N,
                   int64_t sid_bytes, int64_t* ids, uint8_t* vals,
                   int64_t* count) {
    int64_t L;
    int rc = read_vint(rec, len, p, &L);
    if (rc) return rc;
    if (L < 0 || L > N) return -2;
    *count = L;
    if (L == 0) return 0;
    const int64_t n_groups = (L + 63) / 64;
    if (*p + n_groups * sid_bytes > len) return -2;
    for (int64_t g = 0; g < n_groups; ++g) {
        int64_t s = 0;
        for (int64_t b = 0; b < sid_bytes; ++b)
            s |= static_cast<int64_t>(rec[*p + g * sid_bytes + b]) << (8 * b);
        ids[g * 64] = s;
    }
    *p += n_groups * sid_bytes;
    const int64_t rg = (L + 3) / 4;
    if (*p + rg > len) return -2;
    for (int64_t i = 0; i < L; ++i)
        vals[i] = (rec[*p + (i >> 2)] >> (2 * (i & 3))) & 3;
    *p += rg;
    for (int64_t g = 0; g < n_groups; ++g) {
        const int64_t size = std::min<int64_t>(64, L - g * 64);
        int64_t prev = ids[g * 64];
        for (int64_t i = 1; i < size; ++i) {
            int64_t d;
            rc = read_vint(rec, len, p, &d);
            if (rc) return rc;
            // A valid delta is in [1, N): ids are strictly increasing in
            // [0, N). Rejecting here (not only at the post-hoc monotone
            // check) keeps `prev + d` far from int64 overflow -- a
            // crafted 9-byte vint delta could otherwise make the sum
            // undefined behavior before the check runs.
            if (d <= 0 || d >= N) return -2;
            prev += d;
            ids[g * 64 + i] = prev;
        }
    }
    // Sample ids must be strictly increasing in [0, N) (spec; also what
    // makes a misparse loud instead of silently corrupting genotypes).
    if (ids[0] < 0 || ids[L - 1] >= N) return -2;
    for (int64_t i = 1; i < L; ++i)
        if (ids[i] <= ids[i - 1]) return -2;
    return 0;
}

const uint8_t INV[4] = {2, 1, 0, 3};  // hom swap; het/missing fixed

}  // namespace

extern "C" {

// Decode variant records [0, n_var) of a mode-0x10/0x11 PGEN.
//   recs:     contiguous record bytes; record v at [rec_off[v], rec_off[v+1])
//   vrtypes:  n_var vrtype bytes
//   skip:     leading variants decoded only to rebuild the LD base state
//   base:     (N,) caller-persisted LD-base genotypes; *base_valid in/out
//   out:      (n_var - skip, N) uint8 genotypes, 3 = missing
// Returns 0, or <0: -2 malformed record, -3 LD record without a base.
// (The "2" suffix marks the spec-conformant vrtype model -- a stale
// shared library predating it must fail symbol lookup, not decode.)
int64_t na_pgen_decode2(const uint8_t* recs, const int64_t* rec_off,
                        const uint8_t* vrtypes, int64_t n_var, int64_t skip,
                        int64_t N, int64_t sid_bytes, uint8_t* base,
                        int64_t* base_valid, uint8_t* out) {
    std::vector<uint8_t> scratch(static_cast<size_t>(N));
    std::vector<int64_t> ids(static_cast<size_t>(N));
    std::vector<uint8_t> vals(static_cast<size_t>(N));
    for (int64_t v = 0; v < n_var; ++v) {
        uint8_t* row = (v >= skip) ? out + (v - skip) * N : scratch.data();
        const uint8_t vt = vrtypes[v];
        const uint8_t t = vt & 7;
        const uint8_t* rec = recs + rec_off[v];
        const int64_t len = rec_off[v + 1] - rec_off[v];
        int64_t p = 0, L = 0;
        int rc = 0;
        switch (t) {
            case 0: {
                if ((N + 3) / 4 > len) return -2;
                for (int64_t i = 0; i < N; ++i)
                    row[i] = (rec[i >> 2] >> (2 * (i & 3))) & 3;
                p = (N + 3) / 4;
                break;
            }
            case 1: {  // onebit: value0 = C >> 2, value1 = value0 + (C & 3)
                if (1 + (N + 7) / 8 > len) return -2;
                const uint8_t lo = rec[0] >> 2, delta = rec[0] & 3;
                if (lo + delta > 3) return -2;
                const uint8_t hi = lo + delta;
                for (int64_t i = 0; i < N; ++i)
                    row[i] = (rec[1 + (i >> 3)] >> (i & 7)) & 1 ? hi : lo;
                p = 1 + (N + 7) / 8;
                rc = parse_difflist(rec, len, &p, N, sid_bytes, ids.data(),
                                    vals.data(), &L);
                if (rc) return rc;
                for (int64_t i = 0; i < L; ++i) row[ids[i]] = vals[i];
                break;
            }
            case 2:
            case 3: {  // LD / inverted-LD difflist
                if (!*base_valid) return -3;
                if (t == 2) {
                    std::memcpy(row, base, static_cast<size_t>(N));
                } else {
                    for (int64_t i = 0; i < N; ++i) row[i] = INV[base[i]];
                }
                rc = parse_difflist(rec, len, &p, N, sid_bytes, ids.data(),
                                    vals.data(), &L);
                if (rc) return rc;
                for (int64_t i = 0; i < L; ++i) row[ids[i]] = vals[i];
                break;
            }
            default: {  // 4..7: difflist against the constant (vt & 3)
                std::memset(row, t & 3, static_cast<size_t>(N));
                rc = parse_difflist(rec, len, &p, N, sid_bytes, ids.data(),
                                    vals.data(), &L);
                if (rc) return rc;
                for (int64_t i = 0; i < L; ++i) row[ids[i]] = vals[i];
                break;
            }
        }
        // No aux-track bits -> the main track must consume the record
        // exactly (leftover bytes mean a misparse, not padding).
        if (!(vt & 0xF8) && p != len) return -2;
        if ((t & 6) != 2) {
            std::memcpy(base, row, static_cast<size_t>(N));
            *base_valid = 1;
        }
    }
    return 0;
}

}  // extern "C"
