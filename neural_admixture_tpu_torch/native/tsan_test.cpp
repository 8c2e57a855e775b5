// ThreadSanitizer harness of the native host decoder (native/bed_decode.cpp).
//
// The counterpart of the JAX package's native/tsan_test.cpp, at shapes that
// make every threaded entry point start more than one thread:
// parallel_chunks runs a call whose work fits one chunk on the calling
// thread, so such a shape gives ThreadSanitizer nothing to check. Built and
// run by native/tsan.py (python -m neural_admixture_tpu_torch.native.tsan)
// with g++ -O1 -g -pthread -fsanitize=thread; any report ends the run
// non-zero (TSAN_OPTIONS=halt_on_error=1).
//
// Each threaded call prints the chunking its shape gives and the pool size
// (std::thread::hardware_concurrency) and fails when either is below 2;
// tsan.py holds the chunk sizes below against the ones bed_decode.cpp passes
// to parallel_chunks. Every result is checked against a plain loop of the
// same function, and na_pgen_decode2 (sequential today) decodes a handful of
// records of every record type built here, against the genotypes they
// encode.
//
// `tsan_test --canary` runs a deliberate data race instead (two threads
// incrementing a plain int), which ThreadSanitizer must report: proof that
// the build instruments the code.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
void na_decode_bed(const uint8_t*, int64_t, int64_t, int64_t, uint8_t*);
void na_bed_to_packed(const uint8_t*, int64_t, int64_t, int64_t, int64_t,
                      uint8_t*);
void na_pack_2bit(const uint8_t*, int64_t, int64_t, int64_t, uint8_t*);
double na_loglikelihood(const uint8_t*, const double*, const double*, int64_t,
                        int64_t, int64_t, double);
int64_t na_pgen_decode2(const uint8_t*, const int64_t*, const uint8_t*,
                        int64_t, int64_t, int64_t, int64_t, uint8_t*,
                        int64_t*, uint8_t*);
}

namespace {

// The chunk each threaded entry point gives parallel_chunks, and over which
// dimension (bed_decode.cpp; tsan.py checks them against the source).
struct Chunking {
  const char* name;
  const char* dim;
  int64_t chunk;
};
constexpr Chunking kDecode = {"na_decode_bed", "N", 4096};
constexpr Chunking kToPacked = {"na_bed_to_packed", "N", 4096};
constexpr Chunking kPack = {"na_pack_2bit", "N", 256};
constexpr Chunking kLoglik = {"na_loglikelihood", "M", 256};

// Shapes: N over two 4096-sample chunks and a multiple of neither 4 nor
// 4096 (a ragged last BED byte and a ragged last chunk); M over the SNP
// tiles of the decoders (1024, 2048) and over 256, not a multiple of 4; the
// log-likelihood on the first N_LL rows (its threads split M).
constexpr int64_t N = 9001, M = 2500, N_LL = 1031, K = 5;
constexpr uint8_t LUT[4] = {2, 3, 1, 0};  // PLINK code -> dosage

// Prints the call's chunking; false when it would run on one thread.
bool threaded(const Chunking& c, int64_t total) {
  const int64_t chunks = (total + c.chunk - 1) / c.chunk;
  const int64_t pool = std::thread::hardware_concurrency();
  std::printf("call %s dim=%s total=%lld chunk=%lld chunks=%lld pool=%lld "
              "threads=%lld\n", c.name, c.dim, (long long)total,
              (long long)c.chunk, (long long)chunks, (long long)pool,
              (long long)std::min(pool, chunks));
  if (chunks < 2 || pool < 2) {
    std::fprintf(stderr, "%s: %lld chunk(s) on a pool of %lld: one thread, "
                 "nothing for ThreadSanitizer to check\n", c.name,
                 (long long)chunks, (long long)pool);
    return false;
  }
  return true;
}

int fail(const char* what, long long at) {
  std::fprintf(stderr, "%s (at %lld)\n", what, at);
  return 2;
}

// ---- PGEN records (the spec model of io/pgen_standard.py) ----

void put_vint(std::vector<uint8_t>& r, uint64_t v) {
  while (v >= 0x80) {
    r.push_back(static_cast<uint8_t>((v & 0x7F) | 0x80));
    v >>= 7;
  }
  r.push_back(static_cast<uint8_t>(v));
}

// Difflist: count, each 64-id group's first id (sid_bytes, little-endian),
// the 2-bit values, then each group's id deltas.
void put_difflist(std::vector<uint8_t>& r, const std::vector<int64_t>& ids,
                  const std::vector<uint8_t>& vals, int sid_bytes) {
  const int64_t L = static_cast<int64_t>(ids.size());
  put_vint(r, static_cast<uint64_t>(L));
  if (L == 0) return;
  const int64_t groups = (L + 63) / 64;
  for (int64_t g = 0; g < groups; ++g)
    for (int b = 0; b < sid_bytes; ++b)
      r.push_back(static_cast<uint8_t>(ids[g * 64] >> (8 * b)));
  const size_t v0 = r.size();
  r.resize(v0 + static_cast<size_t>((L + 3) / 4), 0);
  for (int64_t i = 0; i < L; ++i)
    r[v0 + i / 4] |= static_cast<uint8_t>(vals[i] << (2 * (i % 4)));
  for (int64_t g = 0; g < groups; ++g)
    for (int64_t i = g * 64 + 1; i < std::min(L, g * 64 + 64); ++i)
      put_vint(r, static_cast<uint64_t>(ids[i] - ids[i - 1]));
}

void apply(std::vector<uint8_t>& row, const std::vector<int64_t>& ids,
           const std::vector<uint8_t>& vals) {
  for (size_t i = 0; i < ids.size(); ++i) row[ids[i]] = vals[i];
}

// Seven records of every record type (0 plain, 1 onebit with exceptions,
// 2 LD, 3 inverted LD, 4-7 difflists against a constant, one of two id
// groups) decoded in one call against the rows they encode.
int check_pgen() {
  const int sid_bytes = 2;  // N < 65536
  std::vector<std::vector<uint8_t>> recs, want;
  std::vector<uint8_t> vrtypes;
  std::vector<uint8_t> row(N), r;

  for (int64_t i = 0; i < N; ++i) row[i] = (i * 7 + i / 5) % 4;  // plain
  r.assign((N + 3) / 4, 0);
  for (int64_t i = 0; i < N; ++i) r[i / 4] |= row[i] << (2 * (i % 4));
  recs.push_back(r), want.push_back(row), vrtypes.push_back(0);

  // onebit: header C = (low value 0) << 2 | (delta 2), bit set -> 2
  r.assign(1 + (N + 7) / 8, 0);
  r[0] = 2;
  for (int64_t i = 0; i < N; ++i) {
    row[i] = i % 3 == 0 ? 2 : 0;
    if (row[i]) r[1 + i / 8] |= 1 << (i % 8);
  }
  put_difflist(r, {5, 100, N - 1}, {1, 3, 1}, sid_bytes);
  apply(row, {5, 100, N - 1}, {1, 3, 1});
  recs.push_back(r), want.push_back(row), vrtypes.push_back(1);
  const std::vector<uint8_t> base = row;  // the last non-LD record

  r.clear();  // LD: the base with two changes
  put_difflist(r, {0, 7}, {3, 2}, sid_bytes);
  row = base;
  apply(row, {0, 7}, {3, 2});
  recs.push_back(r), want.push_back(row), vrtypes.push_back(2);

  r.clear();  // inverted LD: 0 <-> 2 of the base, then one change
  put_difflist(r, {42}, {0}, sid_bytes);
  for (int64_t i = 0; i < N; ++i)
    row[i] = base[i] == 3 ? 3 : static_cast<uint8_t>(2 - base[i]);
  apply(row, {42}, {0});
  recs.push_back(r), want.push_back(row), vrtypes.push_back(3);

  r.clear();  // constant 1 (vrtype 5), no exception
  put_difflist(r, {}, {}, sid_bytes);
  std::fill(row.begin(), row.end(), 1);
  recs.push_back(r), want.push_back(row), vrtypes.push_back(5);

  std::vector<int64_t> ids;  // constant 0 (vrtype 4), 70 ids: two groups
  std::vector<uint8_t> vals;
  for (int64_t j = 0; j < 70; ++j) {
    ids.push_back(10 * (j + 1));
    vals.push_back(static_cast<uint8_t>(j % 4));
  }
  r.clear();
  put_difflist(r, ids, vals, sid_bytes);
  std::fill(row.begin(), row.end(), 0);
  apply(row, ids, vals);
  recs.push_back(r), want.push_back(row), vrtypes.push_back(4);

  r.clear();  // constant 2 (vrtype 6), the last sample missing
  put_difflist(r, {N - 1}, {3}, sid_bytes);
  std::fill(row.begin(), row.end(), 2);
  apply(row, {N - 1}, {3});
  recs.push_back(r), want.push_back(row), vrtypes.push_back(6);

  const int64_t n_var = static_cast<int64_t>(recs.size());
  std::vector<uint8_t> bytes;
  std::vector<int64_t> off = {0};
  for (const auto& rec : recs) {
    bytes.insert(bytes.end(), rec.begin(), rec.end());
    off.push_back(static_cast<int64_t>(bytes.size()));
  }
  std::vector<uint8_t> out(n_var * N, 0xff), ld_base(N, 0);
  int64_t base_valid = 0;
  const int64_t rc = na_pgen_decode2(bytes.data(), off.data(), vrtypes.data(),
                                     n_var, 0, N, sid_bytes, ld_base.data(),
                                     &base_valid, out.data());
  std::printf("call na_pgen_decode2 sequential records=%lld types=0-6 "
              "rc=%lld\n", (long long)n_var, (long long)rc);
  if (rc != 0) return fail("na_pgen_decode2 rejected the records", rc);
  for (int64_t v = 0; v < n_var; ++v)
    for (int64_t i = 0; i < N; ++i)
      if (out[v * N + i] != want[v][i])
        return fail("na_pgen_decode2 differs from the encoded genotypes",
                    v * N + i);
  if (!base_valid || ld_base != want.back())
    return fail("na_pgen_decode2 left another LD base than the last non-LD "
                "record", n_var);
  return 0;
}

int canary() {
  int counter = 0;  // a plain int: the race
  auto bump = [&counter] {
    for (int i = 0; i < 1000; ++i) ++counter;
  };
  std::thread a(bump), b(bump);
  a.join();
  b.join();
  std::printf("canary: counter %d\n", counter);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc > 1 && std::strcmp(argv[1], "--canary") == 0) return canary();

  const int64_t nbytes = (N + 3) / 4;
  const int64_t W = ((M + 2047) / 2048 * 2048) / 4;
  std::vector<uint8_t> bed(M * nbytes);
  for (size_t i = 0; i < bed.size(); ++i)
    bed[i] = static_cast<uint8_t>(i * 2654435761u);

  if (!threaded(kDecode, N)) return 3;
  std::vector<uint8_t> geno(N * M);
  na_decode_bed(bed.data(), M, nbytes, N, geno.data());
  int64_t missing = 0;
  for (int64_t n = 0; n < N; ++n)
    for (int64_t m = 0; m < M; ++m) {
      const uint8_t code = (bed[m * nbytes + n / 4] >> (2 * (n % 4))) & 3;
      if (geno[n * M + m] != LUT[code])
        return fail("na_decode_bed differs from the plain decode", n * M + m);
      missing += code == 1;
    }
  if (missing == 0) return fail("no missing code in the BED bytes", 0);

  if (!threaded(kToPacked, N)) return 3;
  std::vector<uint8_t> packed(N * W, 0);
  na_bed_to_packed(bed.data(), M, nbytes, N, W, packed.data());

  if (!threaded(kPack, N)) return 3;
  std::vector<uint8_t> packed2(N * W, 0);
  na_pack_2bit(geno.data(), N, M, W, packed2.data());
  for (int64_t n = 0; n < N; ++n)
    for (int64_t j = 0; j < 4 * W; ++j) {
      const uint8_t want = j < M ? geno[n * M + j] & 3 : 0;
      if (((packed2[n * W + j / 4] >> (2 * (j % 4))) & 3) != want)
        return fail("na_pack_2bit differs from the plain pack", n * W + j / 4);
    }
  if (packed != packed2)
    return fail("na_bed_to_packed differs from na_pack_2bit(na_decode_bed)",
                0);

  if (!threaded(kLoglik, M)) return 3;
  std::vector<double> P(M * K), Q(N_LL * K);
  for (int64_t i = 0; i < M * K; ++i)
    P[i] = 0.05 + 0.9 * ((i * 37) % 101) / 100.0;
  for (int64_t i = 0; i < N_LL; ++i)
    for (int64_t k = 0; k < K; ++k) Q[i * K + k] = (1.0 + (i + k) % 3) / 10.0;
  const double eps = 1e-6;
  const double ll = na_loglikelihood(geno.data(), P.data(), Q.data(), N_LL, M,
                                     K, eps);
  double want = 0.0;
  for (int64_t j = 0; j < M; ++j)
    for (int64_t i = 0; i < N_LL; ++i) {
      const uint8_t g = geno[i * M + j];
      if (g == 3) continue;
      double rec = 0.0;
      for (int64_t k = 0; k < K; ++k) rec += Q[i * K + k] * P[j * K + k];
      rec = std::max(eps, std::min(rec, 1.0 - eps));
      const double gd = std::max(eps, std::min(static_cast<double>(g),
                                               2.0 - eps));
      want += gd * std::log(rec) + (2.0 - gd) * std::log1p(-rec);
    }
  if (!(std::fabs(ll - want) <= 1e-9 * std::fabs(want)))
    return fail("na_loglikelihood differs from the plain sum", 0);

  const int rc = check_pgen();
  if (rc) return rc;
  std::printf("tsan harness ok: loglik %.6f, %lld missing codes\n", ll,
              (long long)missing);
  return 0;
}
