// ngsld_native — host-side native runtime for ngsld-tpu.
//
// The device path is JAX/XLA/Pallas; this library covers the host-side
// bottlenecks the reference implements in C++ (gzip GL parsing,
// read_data.cpp:13-116, and the printf-based TSV emission,
// ngsLD.cpp:314-351): a gz text/binary genotype-likelihood reader and a
// bulk row formatter. Semantics are identical to ngsld_tpu.strict (itself
// byte-exact against the reference): same tokenizer rules, same libm
// normalization, same "%f" output contract.
//
// Exposed as a plain C ABI for ctypes. Original code, written for this
// project.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <mutex>
#include <thread>
#include <type_traits>
#include <vector>
#include <zlib.h>

namespace {

constexpr double kNegInfSentinel = -1e15;  // strict._NEG_INF_SENTINEL
constexpr int kNGeno = 3;

void set_err(char* err, long errlen, const char* msg) {
  if (err && errlen > 0) {
    std::snprintf(err, (size_t)errlen, "%s", msg);
  }
}

// log-softmax of a 3-vector in place (post_prob semantics: stable
// max-shift logsum, sequential order; mirrors strict.post_prob3)
inline void post_prob3(double* g) {
  double m = g[0];
  if (g[1] >= m) m = g[1];
  if (g[2] >= m) m = g[2];
  double norm;
  if (m == -INFINITY) {
    norm = -INFINITY;
  } else {
    double s = std::exp(g[0] - m);
    s += std::exp(g[1] - m);
    s += std::exp(g[2] - m);
    norm = std::log(s) + m;
  }
  g[0] -= norm;
  g[1] -= norm;
  g[2] -= norm;
}

inline double log_or_sentinel(double v, bool clamp) {
  // C log(): 0 -> -inf, negative -> NaN. clamp=-inf->-1e15 only on the
  // binary-input path (conv_space semantics).
  double r;
  if (v > 0.0) r = std::log(v);
  else if (v == 0.0) r = -INFINITY;
  else r = NAN;
  if (clamp && r == -INFINITY) r = kNegInfSentinel;
  return r;
}

// strtod token that must consume the whole token (split() drops partial
// parses); returns true and writes *out when fully numeric.
inline bool strtod_full(const char* tok, size_t len, double* out) {
  if (len == 0) return false;
  // tokens are NUL-terminated slices prepared by the caller
  char* end = nullptr;
  double v = std::strtod(tok, &end);
  if (end != tok + len) return false;
  *out = v;
  return true;
}

// ---- fast printf-compatible number formatting -----------------------------
//
// snprintf("%f") costs ~150-200ns/field through glibc's arbitrary-precision
// path; rows have 17 fields and runs print millions of rows. These helpers
// produce BYTE-IDENTICAL output for the values this tool prints (fuzzed
// against CPython's correctly-rounded dtoa in tests/test_native.py) and fall
// back to snprintf outside their proven range.
//
// Exactness argument for fmt_f6: |v| < 1e9 has <= 53 significant bits;
// v * 10^6 needs <= 53+20 = 73 bits, exact in __float128 (113-bit mantissa);
// the integer n and remainder w-n are then exact, so round-to-nearest with
// ties-to-even on (n, frac) reproduces IEEE-correct decimal rounding --
// which is what glibc %f (FE_TONEAREST) and CPython's dtoa implement.

static const char kDigitPairs[201] =
    "00010203040506070809101112131415161718192021222324"
    "25262728293031323334353637383940414243444546474849"
    "50515253545556575859606162636465666768697071727374"
    "75767778798081828384858687888990919293949596979899";

static inline char* fmt_int(char* p, long long x) {
  if (x < 0) {
    *p++ = '-';
    x = -x;
  }
  char tmp[24];
  int k = 0;
  while (x >= 100) {  // two digits per divide (div-by-100 is a multiply)
    std::memcpy(tmp + k, kDigitPairs + 2 * (unsigned)(x % 100), 2);
    k += 2;
    x /= 100;
  }
  if (x >= 10) {  // leading 1-2 digits straight to the output
    std::memcpy(p, kDigitPairs + 2 * (unsigned)x, 2);
    p += 2;
  } else {
    *p++ = (char)('0' + x);
  }
  while (k) {  // then the buffered pairs, most-significant first
    k -= 2;
    std::memcpy(p, tmp + k, 2);
    p += 2;
  }
  return p;
}

static inline unsigned pair16(unsigned d) {  // little-endian 2-digit chunk
  unsigned short v;
  std::memcpy(&v, kDigitPairs + 2 * d, 2);
  return v;
}

static inline char* emit_f6(char* p, unsigned long long n) {
  // LD stats print single-digit integer parts almost always (probabilities,
  // r2, chi2<512 band): fuse "d.dddddd" into ONE unaligned 8-byte store —
  // the divides by constants compile to multiplies, and there is no
  // data-dependent branch left for the predictor to miss.
  unsigned fp = (unsigned)(n % 1000000ULL);
  unsigned d01 = fp / 10000, rem = fp % 10000;
  unsigned d23 = rem / 100, d45 = rem % 100;
  unsigned long long ip = n / 1000000ULL;
  if (__builtin_expect(ip < 10, 1)) {
    uint64_t w = (uint64_t)('0' + ip) | ((uint64_t)'.' << 8) |
                 ((uint64_t)pair16(d01) << 16) |
                 ((uint64_t)pair16(d23) << 32) |
                 ((uint64_t)pair16(d45) << 48);
    std::memcpy(p, &w, 8);
    return p + 8;
  }
  p = fmt_int(p, (long long)ip);
  *p++ = '.';
  uint64_t w = (uint64_t)pair16(d01) | ((uint64_t)pair16(d23) << 16) |
               ((uint64_t)pair16(d45) << 32);
  std::memcpy(p, &w, 6);
  return p + 6;
}

// nan/inf spelled the way glibc %f spells them ("nan", "-nan", "inf",
// "-inf"; the sign of a nan is its sign BIT, which glibc honors). Corner
// EM pairs derive nan D'/chi2 in bulk — sprintf here costs ~150 ns/field.
// noinline + bit-level sign: inlined next to `rr * rr`, GCC folds
// signbit(x*x) to 0 (nan signs are "unspecified" to the optimizer) while
// the runtime register genuinely holds -nan — which printf would print.
// The call boundary forces the real value; memcpy reads its real bits.
static __attribute__((noinline)) char* emit_nonfinite(char* p, double v) {
  uint64_t bits;
  std::memcpy(&bits, &v, sizeof bits);
  if (bits >> 63) *p++ = '-';
  const char* s = std::isnan(v) ? "nan" : "inf";
  *p++ = s[0]; *p++ = s[1]; *p++ = s[2];
  return p;
}

// "%f" (6 decimals), glibc-identical for finite |v| < 1e9.
static inline char* fmt_f6(char* p, double v) {
  if (!(std::fabs(v) < 1e9)) {  // nan, inf, huge -> glibc
    if (!std::isfinite(v)) return emit_nonfinite(p, v);
    return p + std::sprintf(p, "%f", v);
  }
  if (std::signbit(v)) {
    *p++ = '-';
    v = -v;
  }
  // Fast path: for v < 512 the double product w = v*1e6 is within
  // ulp(w)/2 <= 6e-8 of the exact product t, so when the fractional part
  // r = w - floor(w) is farther than 1e-7 from the one rounding boundary
  // (0.5) the decision matches exact rounding:
  //   r <= 0.5-1e-7: t < n+0.5 strictly, and even if t dips below n
  //     (t in (n-6e-8, n)) it still rounds UP to n -- emit n either way;
  //   r >= 0.5+1e-7: t > n+0.5 strictly and t < n+1+6e-8, so it rounds to
  //     n+1 whether t sits below or above the integer n+1.
  // Near-integer fractions are therefore safe (ties live at .5, not at
  // integers); this matters because converged EM corners print exact
  // 0.000000/1.000000 constantly. Only the |r-0.5| < 1e-7 band (incl. all
  // exact ties) takes the __float128 path, whose 113-bit product is exact
  // for |v| < 1e9.
  if (v < 512.0) {
    double w = v * 1e6;
    unsigned long long n = (unsigned long long)w;
    double r = w - (double)n;
    // Branchless round-half decision (r >= 0.5 is a 50/50 coin on real
    // stat columns — as a branch it was the formatter's dominant
    // mispredict); only the rare |r-0.5| < 1e-7 band (incl. exact ties)
    // falls through to the correctly-rounded __float128 path.
    if (__builtin_expect(std::fabs(r - 0.5) >= 1e-7, 1))
      return emit_f6(p, n + (r >= 0.5));
  }
  __float128 w = (__float128)v * 1000000;  // exact
  unsigned long long n = (unsigned long long)w;
  __float128 frac = w - (__float128)n;
  if (frac > (__float128)0.5 || (frac == (__float128)0.5 && (n & 1))) n++;
  return emit_f6(p, n);
}

// "%.0f", glibc-identical for integral finite |v| < 1e15 (the dist column
// is a sum of exact integer position deltas, or +inf across contigs).
static inline char* fmt_f0(char* p, double v) {
  if (!(std::fabs(v) < 1e15) || v != std::floor(v)) {
    if (!std::isfinite(v)) return emit_nonfinite(p, v);
    return p + std::sprintf(p, "%.0f", v);
  }
  if (std::signbit(v)) {  // includes -0.0 -> "-0"
    *p++ = '-';
    v = -v;
  }
  return fmt_int(p, (long long)v);
}

// GSL-taus-compatible RNG (L'Ecuyer 1996), bit-for-bit the same stream as
// ngsld_tpu.gsl_rng.TausRNG (itself pinned against gsl_rng_taus): the
// reference samples pairs from per-anchor child streams seeded by a master
// stream (ngsLD.cpp:68-70,164-166,277), and --rnd_sample --seed replication
// requires this exact generator.
struct Taus {
  uint32_t z1, z2, z3;
  void seed(uint64_t s) {
    if (!s) s = 1;
    z1 = (uint32_t)(69069ULL * s);
    if (z1 < 2) z1 += 2;
    z2 = (uint32_t)(69069ULL * z1);
    if (z2 < 8) z2 += 8;
    z3 = (uint32_t)(69069ULL * z2);
    if (z3 < 16) z3 += 16;
    for (int i = 0; i < 6; i++) get();
  }
  uint32_t get() {
    z1 = ((z1 & 4294967294u) << 12) ^ (((z1 << 13) ^ z1) >> 19);
    z2 = ((z2 & 4294967288u) << 4) ^ (((z2 << 2) ^ z2) >> 25);
    z3 = ((z3 & 4294967280u) << 17) ^ (((z3 << 3) ^ z3) >> 11);
    return z1 ^ z2 ^ z3;
  }
  double uniform() { return get() / 4294967296.0; }
};

}  // namespace

extern "C" {

// Per-anchor child-stream seeds, drawn sequentially from the master stream
// in site order (ngsLD.cpp:164-166): uint64(uniform * 1e15).
void ngsld_child_seeds(uint64_t master_seed, int64_t n, uint64_t* out) {
  Taus m;
  m.seed(master_seed);
  for (int64_t i = 0; i < n; i++) out[i] = (uint64_t)(m.uniform() * 1e15);
}

// Banded pair enumeration for one anchor slab [s_start, s_end): candidates
// t in (s, s+counts[s]], partner-MAF skip (NaN passes, ngsLD.cpp:270),
// taus sampling (one draw per surviving candidate in s2 order, :277),
// distances with inf across contigs. counts[] already encodes the band
// limits and the anchor-MAF break (plan.band semantics). Outputs must have
// capacity sum(counts[s_start:s_end]); returns the kept count.
int64_t ngsld_plan_slab(int64_t s_start, int64_t s_end, const int64_t* counts,
                        const double* maf, double min_maf,
                        const int64_t* contig, const double* pos,
                        double rnd_sample, const uint64_t* seeds, int64_t* a,
                        int64_t* b, double* d) {
  int64_t k = 0;
  const bool sample = rnd_sample < 1.0;
  for (int64_t s = s_start; s < s_end; s++) {
    const int64_t c = counts[s];
    if (c <= 0) continue;
    Taus rng;
    if (sample) rng.seed(seeds[s]);
    const int64_t cs = contig[s];
    const double ps = pos[s];
    for (int64_t t = s + 1; t <= s + c; t++) {
      bool keep = !(maf[t] < min_maf);
      if (keep && sample) keep = !(rng.uniform() > rnd_sample);
      if (keep) {
        a[k] = s;
        b[k] = t;
        d[k] = (cs == contig[t]) ? pos[t] - ps : INFINITY;
        k++;
      }
    }
  }
  return k;
}

}  // extern "C"

namespace {

// Parse one CHOMPED text GL line into a single site record (n_ind*3
// doubles, log-scale normalized). fields is a caller-owned growable
// scratch. Returns 0 = record written, 1 = header line (skip, no slot),
// 2 = empty line (slot consumed, record left at the raw sentinel),
// negative = error code with err filled.
int parse_geno_line(char* line, size_t len, int in_probs, int in_logscale,
                    int64_t n_ind, bool first_site, double** fields,
                    int64_t* fields_cap, double* g_site, char* err,
                    long errlen) {
  const int64_t n_geno = in_probs ? kNGeno : 1;
  const int64_t need = n_ind * n_geno;
  const double log_third = std::log(1.0 / kNGeno);
  if (len == 0) {
    // empty line consumes a site slot, left at the raw -1e15 init
    for (int64_t i = 0; i < n_ind * kNGeno; i++) g_site[i] = kNegInfSentinel;
    return 2;
  }
  // tokenize on space/tab runs; keep fully-numeric tokens only
  int64_t nf = 0;
  char* p = line;
  while (*p) {
    while (*p == ' ' || *p == '\t') p++;
    if (!*p) break;
    char* tok = p;
    while (*p && *p != ' ' && *p != '\t') p++;
    size_t tlen = (size_t)(p - tok);
    char saved = *p;
    *p = '\0';
    double v;
    if (strtod_full(tok, tlen, &v)) {
      if (nf >= *fields_cap) {
        *fields_cap *= 2;
        *fields = (double*)std::realloc(*fields,
                                        sizeof(double) * (size_t)*fields_cap);
      }
      (*fields)[nf++] = v;
    }
    *p = saved;
    if (saved) p++;
  }
  if (nf == 0 || (first_site && nf < need)) {
    std::fprintf(stderr, "> Header found! Skipping line...\n");
    return 1;
  }
  if (nf < need) {
    set_err(err, errlen, "wrong GENO file format. Less fields than expected!");
    return -3;
  }
  const double* ptr = *fields + (nf - need);
  for (int64_t i = 0; i < n_ind; i++) {
    double* g = g_site + i * kNGeno;
    if (in_probs) {
      for (int k = 0; k < kNGeno; k++) {
        double v = ptr[i * kNGeno + k];
        g[k] = in_logscale ? v : log_or_sentinel(v, /*clamp=*/false);
      }
    } else {
      int64_t gc = (int64_t)ptr[i];  // C double->int truncation
      if (gc >= 0) {
        if (gc > 2) {
          set_err(err, errlen,
                  "wrong GENO file format. Genotypes must be coded as {-1,0,1,2} !");
          return -4;
        }
        g[0] = g[1] = g[2] = kNegInfSentinel;
        g[gc] = 0.0;  // log(1)
      } else {
        g[0] = g[1] = g[2] = log_third;
      }
    }
    post_prob3(g);
  }
  return 0;
}

// The body of the chunk parsers (ngsld_parse_geno_text below): records of
// whole lines into `out`, doubles as parse_geno_line writes them or
// floats narrowed from them. Returns the records written; *rc is 0, or
// the negative error code of the line that stopped the parse.
template <typename T>
int64_t parse_text_lines(char* data, int64_t len, int in_probs,
                         int in_logscale, int64_t n_ind, int64_t s_global,
                         T* out, int64_t max_sites, int64_t* consumed,
                         int64_t* last_end, int* rc, char* err,
                         long errlen) {
  constexpr bool kNarrow = !std::is_same<T, double>::value;
  const int64_t rec = n_ind * kNGeno;
  double* fields = (double*)std::malloc(sizeof(double) * (rec + 4096));
  int64_t fields_cap = rec + 4096;
  std::vector<double> site(kNarrow ? rec : 0);
  int64_t s = 0;
  int64_t pos = 0;
  *rc = 0;
  *last_end = 0;
  while (pos < len && s < max_sites) {
    char* line = data + pos;
    int64_t end = pos;
    while (end < len && data[end] != '\n') end++;
    size_t llen = (size_t)(end - pos);
    pos = end < len ? end + 1 : end;
    data[(line - data) + llen] = '\0';  // safe: either '\n' slot or end pad
    // chomp removed the '\n'; strip ONE trailing '\r' like the gz reader
    if (llen > 0 && line[llen - 1] == '\r') line[--llen] = '\0';
    double* g;
    if constexpr (kNarrow) g = site.data();
    else g = out + s * rec;
    int r = parse_geno_line(line, llen, in_probs, in_logscale, n_ind,
                            s_global + s == 0, &fields, &fields_cap, g, err,
                            errlen);
    if (r < 0) {
      *rc = r;
      break;
    }
    if (r != 1) {
      if constexpr (kNarrow) {
        T* o = out + s * rec;
        for (int64_t i = 0; i < rec; i++) o[i] = (T)g[i];
      }
      s++;
      *last_end = pos;
    }
  }
  std::free(fields);
  *consumed = pos;
  return s;
}

}  // namespace

extern "C" {

// Read a gz (or plain) TEXT genotype/GL file.
//   in_probs: 3 numeric cols per individual; else 1 genotype col in
//             {-1,0,1,2}
//   in_logscale: probs already log-scaled
// out: n_sites * n_ind * 3 doubles, log-scale normalized.
// Returns 0 on success, nonzero with err filled otherwise.
int ngsld_read_geno_text(const char* path, int in_probs, int in_logscale,
                         int64_t n_ind, int64_t n_sites, double* out,
                         char* err, long errlen) {
  gzFile fh = gzopen(path, "r");
  if (!fh) {
    set_err(err, errlen, "cannot open GENO file!");
    return 1;
  }
  gzbuffer(fh, 1 << 20);

  size_t cap = 1 << 20;
  char* buf = (char*)std::malloc(cap);
  double* fields = (double*)std::malloc(sizeof(double) * (n_ind * 3 + 4096));
  int64_t fields_cap = n_ind * 3 + 4096;

  int64_t s = 0;
  int rc = 0;
  while (s < n_sites) {
    // read one full line (grow buffer on demand)
    size_t len = 0;
    bool got = false;
    while (true) {
      if (len + 2 >= cap) {
        cap *= 2;
        buf = (char*)std::realloc(buf, cap);
      }
      if (gzgets(fh, buf + len, (int)(cap - len)) == nullptr) break;
      got = true;
      len += std::strlen(buf + len);
      if (len > 0 && buf[len - 1] == '\n') break;
    }
    if (!got) {
      set_err(err, errlen,
              "GENO file at premature EOF. Check GENO file and number of sites!");
      rc = 2;
      break;
    }
    // chomp: remove ONE trailing \n or \r
    if (len > 0 && (buf[len - 1] == '\n' || buf[len - 1] == '\r')) {
      buf[--len] = '\0';
    }
    int r = parse_geno_line(buf, len, in_probs, in_logscale, n_ind, s == 0,
                            &fields, &fields_cap,
                            out + s * n_ind * kNGeno, err, errlen);
    if (r < 0) {
      rc = -r;
      break;
    }
    if (r != 1) s++;  // header lines consume no site slot
  }
  // EOF check
  if (rc == 0) {
    char c;
    if (gzread(fh, &c, 1) == 1) {
      set_err(err, errlen,
              "GENO file not at EOF. Check GENO file and number of sites!");
      rc = 5;
    }
  }
  std::free(buf);
  std::free(fields);
  gzclose(fh);
  return rc;
}

// Chunked text parsing for the streaming loader: `data` holds WHOLE
// chomp-able lines (the caller splits the decompressed stream at '\n';
// data is MUTATED for tokenization). Parses at most max_sites site
// records starting at global site index s_global (the header rule only
// applies at global site 0). Writes the number of BYTES consumed to
// *consumed (the caller detects not-at-EOF trailing data). Returns the
// number of site records written, or a negative error code.
int64_t ngsld_parse_geno_text(char* data, int64_t len, int in_probs,
                              int in_logscale, int64_t n_ind,
                              int64_t s_global, double* out,
                              int64_t max_sites, int64_t* consumed,
                              char* err, long errlen) {
  int64_t last_end;
  int rc;
  int64_t s = parse_text_lines(data, len, in_probs, in_logscale, n_ind,
                               s_global, out, max_sites, consumed,
                               &last_end, &rc, err, errlen);
  return rc < 0 ? rc : s;
}

// ngsld_parse_geno_text into a table of the loader's dtype: out_f32 makes
// `out` floats, each record narrowed after post_prob3 (the same bits as
// narrowing the f64 records afterwards), else doubles. Returns the records
// written, also when a bad line stopped the parse (*rc its negative code,
// else 0). *last_end: the bytes up to the end of the line of the last
// record written (0 when none), so that a caller parsing one slice of a
// file knows whether anything follows its n_sites-th record.
int64_t ngsld_parse_geno_text_to(char* data, int64_t len, int in_probs,
                                 int in_logscale, int64_t n_ind,
                                 int64_t s_global, void* out, int out_f32,
                                 int64_t max_sites, int64_t* consumed,
                                 int64_t* last_end, int* rc, char* err,
                                 long errlen) {
  if (out_f32)
    return parse_text_lines(data, len, in_probs, in_logscale, n_ind,
                            s_global, (float*)out, max_sites, consumed,
                            last_end, rc, err, errlen);
  return parse_text_lines(data, len, in_probs, in_logscale, n_ind, s_global,
                          (double*)out, max_sites, consumed, last_end, rc,
                          err, errlen);
}

// The lines of data[0, len): its '\n's, and one more for a last line
// without one. At least the records a parse of those bytes writes.
int64_t ngsld_count_lines(const char* data, int64_t len) {
  int64_t n = 0;
  const char* p = data;
  const char* end = data + len;
  while (p < end) {
    const void* nl = std::memchr(p, '\n', (size_t)(end - p));
    n++;
    if (!nl) break;
    p = (const char*)nl + 1;
  }
  return n;
}

// Binary doubles reader (site-major triplets); always in_probs.
int ngsld_read_geno_bin(const char* path, int in_logscale, int64_t n_ind,
                        int64_t n_sites, double* out, char* err, long errlen) {
  gzFile fh = gzopen(path, "rb");
  if (!fh) {
    set_err(err, errlen, "cannot open GENO file!");
    return 1;
  }
  gzbuffer(fh, 1 << 20);
  const int64_t total_bytes = n_sites * n_ind * kNGeno * 8;
  int64_t got = 0;
  while (got < total_bytes) {
    int64_t want = total_bytes - got;
    if (want > (1 << 24)) want = 1 << 24;
    int n = gzread(fh, (char*)out + got, (unsigned)want);
    if (n <= 0) {
      set_err(err, errlen,
              "GENO file at premature EOF. Check GENO file and number of sites!");
      gzclose(fh);
      return 2;
    }
    got += n;
  }
  char c;
  if (gzread(fh, &c, 1) == 1) {
    set_err(err, errlen,
            "GENO file not at EOF. Check GENO file and number of sites!");
    gzclose(fh);
    return 5;
  }
  gzclose(fh);
  for (int64_t si = 0; si < n_sites * n_ind; si++) {
    double* g = out + si * kNGeno;
    if (!in_logscale) {
      g[0] = log_or_sentinel(g[0], true);
      g[1] = log_or_sentinel(g[1], true);
      g[2] = log_or_sentinel(g[2], true);
    }
    post_prob3(g);
    if (std::isnan(g[0]) || std::isnan(g[1]) || std::isnan(g[2])) {
      set_err(err, errlen, "NaN found! Is the file format correct?");
      return 6;
    }
  }
  return 0;
}

// Test-only: batch-format doubles with fmt_f6 / fmt_f0 into fixed 64-byte
// NUL-terminated slots, for fuzz parity checks against CPython's dtoa.
// Callers keep |v| < 1e30 so the snprintf fallback fits the slot.
void ngsld_fmt_batch(const double* v, int64_t n, int zero_dec, char* out) {
  for (int64_t i = 0; i < n; i++) {
    char* p = out + 64 * i;
    char* e = zero_dec ? fmt_f0(p, v[i]) : fmt_f6(p, v[i]);
    *e = '\0';
  }
}

// Positions reader: read_file + read_dist + label pass
// (gen_func.cpp:233-282, read_data.cpp:165-218, ngsLD.cpp:119-132).
// Skips blank/'#' lines, then `header_skip` more; per line: TSV fields
// (count must be constant, >= 2), col2 position via C strtod/strtoul
// (prefix semantics), adjacent distances with +inf at contig changes.
// Labels (line with first tab -> ':', NUL-terminated) are packed into
// `labels` with offsets in label_off.
// Returns 0 ok; -2 labels_cap too small (caller grows + retries);
// 1 open, 2 too few lines, 3 field count, 4 format, 5 zero/non-numeric
// position, 6 invalid distance.
int ngsld_read_pos(const char* path, int64_t header_skip, int64_t n_sites,
                   double* pos_dist, char* labels, int64_t labels_cap,
                   int64_t* label_off, int64_t* labels_len, char* err,
                   long errlen) {
  gzFile fh = gzopen(path, "r");
  if (!fh) {
    set_err(err, errlen, "cannot open POS file!");
    return 1;
  }
  gzbuffer(fh, 1 << 20);

  size_t cap = 1 << 16;
  char* buf = (char*)std::malloc(cap);
  char* prev_chr = nullptr;
  size_t prev_chr_cap = 0, prev_chr_len = 0;
  bool have_prev = false;
  unsigned long prev_pos = 0;
  int64_t n_fields = -1;
  int64_t skipped = 0, s = 0, lab_w = 0;
  int rc = 0;

  while (s < n_sites) {
    size_t len = 0;
    bool got = false;
    while (true) {
      if (len + 2 >= cap) {
        cap *= 2;
        buf = (char*)std::realloc(buf, cap);
      }
      if (gzgets(fh, buf + len, (int)(cap - len)) == nullptr) break;
      got = true;
      len += std::strlen(buf + len);
      if (len > 0 && buf[len - 1] == '\n') break;
    }
    if (!got) {
      // read_split reads ALL lines; the reference errors on any count
      // mismatch (read_data.cpp:178-179)
      set_err(err, errlen, "wrong number of lines in POS file!");
      rc = 2;
      goto done;
    }
    if (len > 0 && (buf[len - 1] == '\n' || buf[len - 1] == '\r')) {
      buf[--len] = '\0';
    }
    if (len == 0 || buf[0] == '#') continue;  // read_file skip rules
    if (skipped < header_skip) {
      skipped++;
      continue;
    }
    // field count = tabs + 1 (split keeps empties); first-field extent
    int64_t nf = 1;
    size_t chr_len = len;
    const char* col2 = nullptr;
    for (size_t i = 0; i < len; i++) {
      if (buf[i] == '\t') {
        if (nf == 1) {
          chr_len = i;
          col2 = buf + i + 1;
        }
        nf++;
      }
    }
    if (n_fields < 0) {
      n_fields = nf;
      if (n_fields < 2) {
        set_err(err, errlen, "wrong POS file format!");
        rc = 4;
        goto done;
      }
    } else if (nf != n_fields) {
      set_err(err, errlen, "invalid number of fields in file!");
      rc = 3;
      goto done;
    }
    {
      // strtod stops at the field's closing tab: C prefix semantics, as
      // the reference applies them (read_data.cpp:188,199)
      double p2 = std::strtod(col2, nullptr);
      if (p2 == 0.0) {
        set_err(err, errlen, "non-numeric/zero position found "
                             "(headered POS file? use --posH)");
        rc = 5;
        goto done;
      }
      bool same = have_prev && prev_chr_len == chr_len &&
                  std::memcmp(prev_chr, buf, chr_len) == 0;
      if (!have_prev) {
        same = true;  // first site: prev_chr adopts this contig
      }
      if (same) {
        double d = p2 - (double)prev_pos;
        if (d < 1.0) {
          set_err(err, errlen, "invalid distance between adjacent sites!");
          rc = 6;
          goto done;
        }
        pos_dist[s] = d;
      } else {
        pos_dist[s] = INFINITY;
      }
      if (chr_len + 1 > prev_chr_cap) {
        prev_chr_cap = (chr_len + 1) * 2;
        prev_chr = (char*)std::realloc(prev_chr, prev_chr_cap);
      }
      std::memcpy(prev_chr, buf, chr_len);
      prev_chr_len = chr_len;
      have_prev = true;
      prev_pos = std::strtoul(col2, nullptr, 0);
    }
    // label: line with first tab -> ':'
    if (lab_w + (int64_t)len + 1 > labels_cap) {
      rc = -2;
      goto done;
    }
    label_off[s] = lab_w;
    std::memcpy(labels + lab_w, buf, len);
    if (chr_len < len) labels[lab_w + chr_len] = ':';
    lab_w += (int64_t)len;
    labels[lab_w++] = '\0';
    s++;
  }
  // any further data line means the file has MORE lines than n_sites:
  // the reference errors (read_data.cpp:178-179) instead of truncating
  while (true) {
    size_t len = 0;
    bool got = false;
    while (true) {
      if (len + 2 >= cap) {
        cap *= 2;
        buf = (char*)std::realloc(buf, cap);
      }
      if (gzgets(fh, buf + len, (int)(cap - len)) == nullptr) break;
      got = true;
      len += std::strlen(buf + len);
      if (len > 0 && buf[len - 1] == '\n') break;
    }
    if (!got) break;  // clean EOF
    if (len > 0 && (buf[len - 1] == '\n' || buf[len - 1] == '\r')) {
      buf[--len] = '\0';
    }
    if (len == 0 || buf[0] == '#') continue;  // read_file skip rules
    set_err(err, errlen, "wrong number of lines in POS file!");
    rc = 2;
    goto done;
  }
  *labels_len = lab_w;
done:
  std::free(buf);
  std::free(prev_chr);
  gzclose(fh);
  return rc;
}

}  // extern "C"

// ---- multithreaded row formatting -----------------------------------------
//
// Shared scaffolding for the bulk TSV formatters: worker t formats its
// contiguous row range into scratch buffer t, then, after every worker is
// done, copies it into `out` at its prefix offset (the copies run in
// parallel too). Returns bytes written, -1 if out_cap is too small (caller
// grows and retries), -2 on allocation failure (caller raises
// MemoryError). `fill` emits one row's numeric columns after the two
// labels and returns the new write pointer; the caller guarantees >= 1024
// bytes of headroom past the labels (ample: worst-case non-label fields
// bound to ~650 bytes even with huge snprintf fallbacks).
//
// The scratch outlives the call: one buffer per worker, grown when a call
// needs more and never shrunk, so a process that formats block after
// block (the emit of every job) allocates and page-faults it once. A call
// leases the set under a lock; a call that finds it taken formats into a
// private set, freed on return, rather than wait.

struct FmtChunk {
  char* buf = nullptr;
  int64_t len = 0;
  int64_t cap = 0;
  bool oom = false;
};

struct FmtScratch {
  std::mutex mu;
  std::vector<FmtChunk> chunks;  // guarded by mu
};

static FmtScratch& fmt_scratch() {
  // never destroyed: a daemon thread may still be formatting while the
  // process runs its static destructors at exit
  static FmtScratch* s = new FmtScratch();
  return *s;
}

template <typename Fill>
static int64_t mt_rows_run(int64_t n_rows, const char* labels,
                              const int64_t* label_off, const int64_t* s1,
                              const int64_t* s2, char* out, int64_t out_cap,
                              int n_threads, Fill fill) {
  if (n_threads < 1) n_threads = 1;
  if ((int64_t)n_threads > n_rows) n_threads = (int)(n_rows ? n_rows : 1);
  if (n_threads == 1) {
    // Single worker (the 1-core box case): format straight into `out` —
    // no scratch buffer, no copy. -1 on would-overflow keeps the caller's
    // grow-and-retry contract.
    char* p = out;
    char* const end = out + out_cap;
    for (int64_t j = 0; j < n_rows; j++) {
      const char* l1 = labels + label_off[s1[j]];
      const char* l2 = labels + label_off[s2[j]];
      size_t n1 = std::strlen(l1), n2 = std::strlen(l2);
      if ((size_t)(end - p) < n1 + n2 + 1024) return -1;
      std::memcpy(p, l1, n1);
      p += n1;
      *p++ = '\t';
      std::memcpy(p, l2, n2);
      p += n2;
      *p++ = '\t';
      p = fill(p, j);
      *p++ = '\n';
    }
    return p - out;
  }
  FmtScratch& kept = fmt_scratch();
  std::unique_lock<std::mutex> lease(kept.mu, std::try_to_lock);
  std::vector<FmtChunk> own;
  std::vector<FmtChunk>& chunks = lease.owns_lock() ? kept.chunks : own;
  if (chunks.size() < (size_t)n_threads) chunks.resize((size_t)n_threads);
  auto parallel = [n_threads](auto&& fn) {
    std::vector<std::thread> ths;
    for (int t = 1; t < n_threads; t++) ths.emplace_back(fn, t);
    fn(0);
    for (auto& th : ths) th.join();
  };
  parallel([&](int t) {
    int64_t lo = n_rows * t / n_threads;
    int64_t hi = n_rows * (t + 1) / n_threads;
    FmtChunk& c = chunks[(size_t)t];
    c.len = 0;
    c.oom = false;
    const int64_t want = (hi - lo) * 96 + 4096;
    if (c.cap < want) {  // nothing to keep: a fresh buffer, not a realloc
      std::free(c.buf);
      c.buf = (char*)std::malloc((size_t)want);
      c.cap = c.buf ? want : 0;
      if (!c.buf) {
        c.oom = true;
        return;
      }
    }
    // the row loop keeps its pointers in locals: the chunks' headers
    // share cache lines, and a store to one a row would bounce them
    // between the workers
    char* p = c.buf;
    char* end = c.buf + c.cap;
    for (int64_t j = lo; j < hi; j++) {
      const char* l1 = labels + label_off[s1[j]];
      const char* l2 = labels + label_off[s2[j]];
      size_t n1 = std::strlen(l1), n2 = std::strlen(l2);
      if ((size_t)(end - p) < n1 + n2 + 1024) {
        const int64_t len = p - c.buf;
        const int64_t cap = c.cap * 2 + (int64_t)(n1 + n2) + 4096;
        char* nb = (char*)std::realloc(c.buf, (size_t)cap);
        if (!nb) {  // c.buf stays valid (and owned) at its old size
          c.oom = true;
          return;
        }
        c.buf = nb;
        c.cap = cap;
        p = nb + len;
        end = nb + cap;
      }
      std::memcpy(p, l1, n1);
      p += n1;
      *p++ = '\t';
      std::memcpy(p, l2, n2);
      p += n2;
      *p++ = '\t';
      p = fill(p, j);
      *p++ = '\n';
    }
    c.len = p - c.buf;
  });
  bool oom = false;
  int64_t total = 0;
  std::vector<int64_t> at((size_t)n_threads);
  for (int t = 0; t < n_threads; t++) {
    oom |= chunks[(size_t)t].oom;
    at[(size_t)t] = total;
    total += chunks[(size_t)t].len;
  }
  int64_t w = oom ? -2 : total <= out_cap ? total : -1;
  if (w >= 0) {
    parallel([&](int t) {
      const FmtChunk& c = chunks[(size_t)t];
      std::memcpy(out + at[(size_t)t], c.buf, (size_t)c.len);
    });
  }
  for (auto& c : own) std::free(c.buf);
  return w;
}

// One row's numeric columns (the printf contract of ngsLD.cpp:314-351),
// shared by the pass-through and derive formatters.
template <typename TF>
static inline char* emit_cols(char* p, double dist, TF r2p, TF D, TF Dp,
                              TF r2, int extend, long long n_used,
                              double maf1, double maf2, TF f0, TF f1, TF f2,
                              TF f3, TF hm0, TF hm1, double chi2,
                              long long n_iter) {
  p = fmt_f0(p, dist);
  *p++ = '\t';
  p = fmt_f6(p, r2p);
  *p++ = '\t';
  p = fmt_f6(p, D);
  *p++ = '\t';
  p = fmt_f6(p, Dp);
  *p++ = '\t';
  p = fmt_f6(p, r2);
  if (extend) {
    *p++ = '\t';
    p = fmt_int(p, n_used);
    *p++ = '\t';
    p = fmt_f6(p, maf1);
    *p++ = '\t';
    p = fmt_f6(p, maf2);
    *p++ = '\t';
    p = fmt_f6(p, f0);
    *p++ = '\t';
    p = fmt_f6(p, f1);
    *p++ = '\t';
    p = fmt_f6(p, f2);
    *p++ = '\t';
    p = fmt_f6(p, f3);
    *p++ = '\t';
    p = fmt_f6(p, hm0);
    *p++ = '\t';
    p = fmt_f6(p, hm1);
    *p++ = '\t';
    p = fmt_f6(p, chi2);
    *p++ = '\t';
    p = fmt_f6(p, 0.0);
    *p++ = '\t';
    p = fmt_int(p, n_iter);
  }
  return p;
}

// Pass-through formatter: every value column supplied as an array. The f32
// engine hands its arrays straight through (float -> double promotion is
// exact, so output bytes match converting host-side first). Extended-array
// reads are guarded: callers pass 1-element dummies when extend == 0.
template <typename TF>
static int64_t format_rows_mt_impl(int64_t n_rows, const char* labels,
                             const int64_t* label_off, const int64_t* s1,
                             const int64_t* s2, const double* dist,
                             const TF* r2p, const TF* D,
                             const TF* Dp, const TF* r2, int extend,
                             const int32_t* n_used, const double* maf1,
                             const double* maf2, const TF* hap,
                             const TF* hmaf1, const TF* hmaf2,
                             const float* chi2, const int32_t* n_iter,
                             char* out, int64_t out_cap, int n_threads) {
  return mt_rows_run(
      n_rows, labels, label_off, s1, s2, out, out_cap, n_threads,
      [&](char* p, int64_t j) {
        if (!extend) {
          return emit_cols<TF>(p, dist[j], r2p[j], D[j], Dp[j], r2[j], 0,
                               0, 0.0, 0.0, (TF)0, (TF)0, (TF)0, (TF)0,
                               (TF)0, (TF)0, 0.0, 0);
        }
        return emit_cols<TF>(p, dist[j], r2p[j], D[j], Dp[j], r2[j], 1,
                             (long long)n_used[j], maf1[j], maf2[j],
                             hap[4 * j], hap[4 * j + 1], hap[4 * j + 2],
                             hap[4 * j + 3], hmaf1[j], hmaf2[j],
                             (double)chi2[j], (long long)n_iter[j]);
      });
}

// Derive-and-format: takes only (r2p, hap freqs) + metadata and computes
// D, D\', r2, hap MAFs, and chi2 per row inside the worker threads,
// mirroring engine._stats_host/_chi2_host op-for-op in the value type
// (ld_stats semantics of ngsLD.cpp:296-306; the reference\'s FLOAT allele
// freqs and expected table inside chi2, :328-333, with a float
// accumulator). Byte-identity vs deriving in NumPy first is pinned by
// tests/test_native.py.
template <typename TF>
static int64_t format_rows_derive_impl(
    int64_t n_rows, const char* labels, const int64_t* label_off,
    const int64_t* s1, const int64_t* s2, const double* dist, const TF* r2p,
    const TF* f, int extend, const int32_t* n_used, const double* maf1,
    const double* maf2, const int32_t* n_iter,
    const int32_t* over_rank,  // per-row rank into the override columns,
                               // -1 = derive normally; NULL = no overrides
    const double* o_cols,      // (n_over, 12): r2p D Dp r2 maf1 maf2
                               //               f0 f1 f2 f3 hm1 hm2
    const float* o_chi2, const int32_t* o_nused, const int32_t* o_niter,
    char* out, int64_t out_cap, int n_threads) {
  auto cmin = [](TF a, TF b) { return a <= b ? a : b; };  // C min() NaN rule
  return mt_rows_run(
      n_rows, labels, label_off, s1, s2, out, out_cap, n_threads,
      [&](char* p, int64_t j) {
        if (over_rank) {
          // Refined (degenerate-tier) rows ship their corrected columns
          // as f64 pass-through values — one formatter pass emits both
          // populations, replacing the old bulk-format + Python splice
          // (bytes identical: the splice emitted these same doubles
          // through the same emit_cols<double>).
          int32_t r = over_rank[j];
          if (r >= 0) {
            const double* oc = o_cols + 12 * (int64_t)r;
            return emit_cols<double>(p, dist[j], oc[0], oc[1], oc[2],
                                     oc[3], extend,
                                     (long long)o_nused[r], oc[4], oc[5],
                                     oc[6], oc[7], oc[8], oc[9], oc[10],
                                     oc[11], (double)o_chi2[r],
                                     (long long)o_niter[r]);
          }
        }
        const TF f0 = f[4 * j], f1 = f[4 * j + 1], f2 = f[4 * j + 2],
                 f3 = f[4 * j + 3];
        const TF one = (TF)1;
        const TF m0 = one - (f0 + f1);     // hap_maf1 (ngsLD.cpp:296)
        const TF m1 = one - (f0 + f2);     // hap_maf2 (:298)
        const TF D = f0 * f3 - f1 * f2;    // (:300)
        const TF neg = -cmin(m0 * m1, (one - m0) * (one - m1));
        const TF pos = cmin(m0 * (one - m1), (one - m0) * m1);
        const TF Dp = D / (D < (TF)0 ? neg : pos);            // (:304)
        const TF rr = D / (TF)std::sqrt(m0 * m1 * (one - m0) * (one - m1));
        const TF r2v = rr * rr;                               // (:306)
        if (!extend) {
          return emit_cols<TF>(p, dist[j], r2p[j], D, Dp, r2v, 0, 0, 0.0,
                               0.0, (TF)0, (TF)0, (TF)0, (TF)0, (TF)0,
                               (TF)0, 0.0, 0);
        }
        // chi2 (:324-333): allele freqs and the expected table are FLOAT
        // locals even when the freqs are double
        const float fA = (float)(f0 + f1), fB = (float)(f0 + f2);
        const TF e0 = (TF)(fA * fB), e1 = (TF)(fA * (1.0f - fB)),
                 e2 = (TF)((1.0f - fA) * fB),
                 e3 = (TF)((1.0f - fA) * (1.0f - fB));
        const TF d0 = f0 - e0, d1 = f1 - e1, d2 = f2 - e2, d3 = f3 - e3;
        float chi2v = 0.0f;
        chi2v = (float)((TF)chi2v + d0 * d0 / e0);
        chi2v = (float)((TF)chi2v + d1 * d1 / e1);
        chi2v = (float)((TF)chi2v + d2 * d2 / e2);
        chi2v = (float)((TF)chi2v + d3 * d3 / e3);
        return emit_cols<TF>(p, dist[j], r2p[j], D, Dp, r2v, 1,
                             (long long)n_used[j], maf1[j], maf2[j], f0, f1,
                             f2, f3, m0, m1, (double)chi2v,
                             (long long)n_iter[j]);
      });
}

// Degenerate-pair tier classification (mirror of refine.degenerate_tiers,
// same f64 ops in the same order -> bit-identical classification; numpy
// spent ~13 s on a 17.9M-row chunk set, this pass ~0.3 s). NaN-propagating
// min matches np.minimum. `stride` is the row stride in ELEMENTS (the
// engine passes a (P, 5) fm matrix's columns 1:5 without copying).
template <typename TF>
static int64_t tier_scan_impl(int64_t n, const TF* f, int64_t stride,
                              int f32_prec, uint8_t* tier) {
  auto nmin = [](double a, double b) {
    if (std::isnan(a) || std::isnan(b)) return std::nan("");
    return a < b ? a : b;
  };
  int64_t count = 0;
  for (int64_t j = 0; j < n; j++) {
    const TF* r = f + j * stride;
    const double f0 = r[0], f1 = r[1], f2 = r[2], f3 = r[3];
    const double m0 = 1.0 - (f0 + f1);
    const double m1 = 1.0 - (f0 + f2);
    const double D = f0 * f3 - f1 * f2;
    const double neg = -nmin(m0 * m1, (1.0 - m0) * (1.0 - m1));
    const double pos = nmin(m0 * (1.0 - m1), (1.0 - m0) * m1);
    const double den_dp = D < 0.0 ? neg : pos;
    const double den_r2 = m0 * m1 * (1.0 - m0) * (1.0 - m1);
    const bool nonfin = !(std::isfinite(f0) && std::isfinite(f1) &&
                          std::isfinite(f2) && std::isfinite(f3));
    uint8_t t = 0;
    if (f32_prec && (std::fabs(den_dp) < 1e-3 ||
                     std::fabs(den_r2) < 1e-6 || std::fabs(D) < 2e-6))
      t = 2;
    // hap-MAF within f32-EM wobble of a simplex boundary: the factor's
    // sign (hence NaN-vs-finite of Dp/r2) is stop-point-dependent ->
    // exact-zero class (mirrors refine.degenerate_tiers)
    const double mn =
        std::min(std::min(std::fabs(m0), std::fabs(m1)),
                 std::min(std::fabs(1.0 - m0), std::fabs(1.0 - m1)));
    if (std::fabs(den_dp) < 1e-7 || std::fabs(den_r2) < 1e-13 ||
        mn < 1e-4 || nonfin)
      t = 1;
    tier[j] = t;
    count += (t != 0);
  }
  return count;
}

extern "C" {

int64_t ngsld_tier_scan32(int64_t n, const float* f, int64_t stride,
                          int f32_prec, uint8_t* tier) {
  return tier_scan_impl<float>(n, f, stride, f32_prec, tier);
}

int64_t ngsld_tier_scan64(int64_t n, const double* f, int64_t stride,
                          int f32_prec, uint8_t* tier) {
  return tier_scan_impl<double>(n, f, stride, f32_prec, tier);
}

// gsl_stats_correlation's stable one-pass update with LONG DOUBLE
// accumulators (x86: 80-bit x87, exactly np.longdouble), squared --
// bit-identical to strict.pearson_r2_batch, which spends ~45 us/pair in
// numpy's scalar longdouble loops. ratio and the final sqrt/product are
// computed in double exactly as GSL does (ngsLD.cpp:365-367).
void ngsld_pearson_r2(const double* x, const double* y, int64_t P,
                      int64_t n, double* out) {
  for (int64_t p = 0; p < P; p++) {
    const double* xr = x + p * n;
    const double* yr = y + p * n;
    long double mean_x = xr[0], mean_y = yr[0];
    long double sxx = 0, syy = 0, sxy = 0;
    for (int64_t i = 1; i < n; i++) {
      const long double ratio = (double)i / ((double)i + 1.0);
      const long double dx = (long double)xr[i] - mean_x;
      const long double dy = (long double)yr[i] - mean_y;
      sxx += dx * dx * ratio;
      syy += dy * dy * ratio;
      sxy += dx * dy * ratio;
      mean_x += dx / (long double)((double)i + 1.0);
      mean_y += dy / (long double)((double)i + 1.0);
    }
    const double denom =
        std::sqrt((double)sxx) * std::sqrt((double)syy);
    const double r = (double)(sxy / (long double)denom);
    out[p] = r * r;
  }
}

int64_t ngsld_format_rows_derive32(
    int64_t n_rows, const char* labels, const int64_t* label_off,
    const int64_t* s1, const int64_t* s2, const double* dist,
    const float* r2p, const float* f, int extend, const int32_t* n_used,
    const double* maf1, const double* maf2, const int32_t* n_iter,
    const int32_t* over_rank, const double* o_cols, const float* o_chi2,
    const int32_t* o_nused, const int32_t* o_niter,
    char* out, int64_t out_cap, int n_threads) {
  return format_rows_derive_impl<float>(
      n_rows, labels, label_off, s1, s2, dist, r2p, f, extend, n_used, maf1,
      maf2, n_iter, over_rank, o_cols, o_chi2, o_nused, o_niter, out,
      out_cap, n_threads);
}

int64_t ngsld_format_rows_derive64(
    int64_t n_rows, const char* labels, const int64_t* label_off,
    const int64_t* s1, const int64_t* s2, const double* dist,
    const double* r2p, const double* f, int extend, const int32_t* n_used,
    const double* maf1, const double* maf2, const int32_t* n_iter,
    const int32_t* over_rank, const double* o_cols, const float* o_chi2,
    const int32_t* o_nused, const int32_t* o_niter,
    char* out, int64_t out_cap, int n_threads) {
  return format_rows_derive_impl<double>(
      n_rows, labels, label_off, s1, s2, dist, r2p, f, extend, n_used, maf1,
      maf2, n_iter, over_rank, o_cols, o_chi2, o_nused, o_niter, out,
      out_cap, n_threads);
}

int64_t ngsld_format_rows_mt(int64_t n_rows, const char* labels,
                             const int64_t* label_off, const int64_t* s1,
                             const int64_t* s2, const double* dist,
                             const double* r2p, const double* D,
                             const double* Dp, const double* r2, int extend,
                             const int32_t* n_used, const double* maf1,
                             const double* maf2, const double* hap,
                             const double* hmaf1, const double* hmaf2,
                             const float* chi2, const int32_t* n_iter,
                             char* out, int64_t out_cap, int n_threads) {
  return format_rows_mt_impl<double>(
      n_rows, labels, label_off, s1, s2, dist, r2p, D, Dp, r2, extend,
      n_used, maf1, maf2, hap, hmaf1, hmaf2, chi2, n_iter, out, out_cap,
      n_threads);
}

// float32 value columns (dist/maf stay double); byte-identical output.
int64_t ngsld_format_rows_mt32(int64_t n_rows, const char* labels,
                               const int64_t* label_off, const int64_t* s1,
                               const int64_t* s2, const double* dist,
                               const float* r2p, const float* D,
                               const float* Dp, const float* r2, int extend,
                               const int32_t* n_used, const double* maf1,
                               const double* maf2, const float* hap,
                               const float* hmaf1, const float* hmaf2,
                               const float* chi2, const int32_t* n_iter,
                               char* out, int64_t out_cap, int n_threads) {
  return format_rows_mt_impl<float>(
      n_rows, labels, label_off, s1, s2, dist, r2p, D, Dp, r2, extend,
      n_used, maf1, maf2, hap, hmaf1, hmaf2, chi2, n_iter, out, out_cap,
      n_threads);
}

}  // extern "C"


// ---------------------------------------------------------------- strict
// refinement pipeline (bit-exact mirrors of ngsld_tpu/strict.py, which in
// turn pins the reference's op order): site preparation (post_prob,
// call_geno, est_maf — gen_func.cpp:886-1009 semantics) and the pair EM
// (pair_freq_iter, gen_func.cpp:1027-1119). Used by refine.StrictRefiner
// so the exact-zero-class recompute is C-speed instead of Python-speed;
// every value must match the Python strict path bit-for-bit
// (tests/test_refine.py pins this).

static const double K_EPSILON = 1e-5;     // gen_func.hpp:16
static const int K_ITER_MAX = 100;        // gen_func.hpp:18
static const double K_NEG_INF = -1e15;    // gen_func.hpp:15 (-INF)

static inline double logsum3_c(double a0, double a1, double a2) {
    double m = a0;                        // strict.logsum3 order
    if (a1 >= m) m = a1;
    if (a2 >= m) m = a2;
    if (m == -INFINITY) return -INFINITY;
    double s = exp(a0 - m);
    s += exp(a1 - m);
    s += exp(a2 - m);
    return log(s) + m;
}

static inline void post_prob3_c(double* g) {
    double n = logsum3_c(g[0], g[1], g[2]);
    g[0] -= n; g[1] -= n; g[2] -= n;
}

static inline int miss3_log(const double* g) {
    return fabs(g[0] - g[1]) < K_EPSILON && fabs(g[1] - g[2]) < K_EPSILON;
}

extern "C" {

// rows: (m, I, 3) f64, EITHER raw binary records (text_norm == 0; the
// optional log + -INF clamp and post_prob run here, read_data.cpp:28-47)
// OR already log-normalized text-parser records (text_norm == 1).
// Outputs: gn (m, I, 3) normal space post-call, maf (m,), eg (m, I).
// Returns 0, or 1 on the reference's NaN error.
int ngsld_strict_siteprep(double* rows, int64_t m, int64_t I,
                          int in_logscale, int text_norm, int call_geno,
                          double N_thresh, double call_thresh,
                          int ignore_miss, double* gn, double* maf,
                          double* eg) {
    for (int64_t s = 0; s < m; s++) {
        for (int64_t i = 0; i < I; i++) {
            double* g = rows + (s * I + i) * 3;
            if (!text_norm) {
                if (!in_logscale) {
                    for (int c = 0; c < 3; c++) {
                        double lg = log(g[c]);
                        g[c] = (lg == -INFINITY) ? K_NEG_INF : lg;
                    }
                }
                post_prob3_c(g);
                if (std::isnan(g[0]) || std::isnan(g[1]) || std::isnan(g[2])) return 1;
            }
            if (call_geno) {
                // strict.call_geno_inplace (gen_func.cpp:886-914):
                // first strict max / first strict min
                int max_pos = 0, min_pos = 0;
                double mx = -INFINITY, mn = INFINITY;
                for (int c = 0; c < 3; c++) {
                    if (g[c] > mx) { mx = g[c]; max_pos = c; }
                    if (g[c] < mn) { mn = g[c]; min_pos = c; }
                }
                double max_pp = exp(mx);
                if (g[min_pos] == g[max_pos]) max_pp = -1.0;
                if (max_pp < N_thresh)
                    g[0] = g[1] = g[2] = log(1.0 / 3.0);
                if (max_pp >= call_thresh) {
                    g[0] = g[1] = g[2] = K_NEG_INF;
                    g[max_pos] = 0.0;   // log(1)
                }
            }
        }
        // est_maf (strict.est_maf_all semantics, gen_func.cpp:974-1009):
        // pp = exp(post_prob(row)) applied AGAIN on the stored row;
        // two passes with NON-resetting accumulators; miss test on the
        // LOG-scale row
        double num = 0.0, den = 0.0, freq1, freq2;
        const double* base = rows + s * I * 3;
        // per-individual accumulator terms are pass-invariant (the row is
        // unchanged between the two passes): compute once, replay in pass
        // 1 — identical values added in the identical order, so the
        // non-resetting accumulator quirk (gen_func.cpp:976-1005) stays
        // bit-exact while the post_prob/exp work halves
        std::vector<double> numi(I), deni(I);
        for (int pass = 0; pass < 2; pass++) {
            for (int64_t i = 0; i < I; i++) {
                if (pass == 0) {
                    const double* g = base + i * 3;
                    if (ignore_miss && miss3_log(g)) {
                        numi[i] = 0.0;
                        deni[i] = 0.0;
                        continue;
                    }
                    double p[3] = {g[0], g[1], g[2]};
                    post_prob3_c(p);
                    double pp0 = exp(p[0]), pp1 = exp(p[1]),
                           pp2 = exp(p[2]);
                    numi[i] = pp1 + pp2 * 2.0;
                    deni[i] = 2.0 * pp1 + (pp0 + pp2) * 2.0;
                } else if (deni[i] == 0.0 && numi[i] == 0.0) {
                    continue;   // the pass-0 miss skip (adds nothing)
                }
                num += numi[i];
                den += deni[i];
            }
            if (pass == 0) {
                freq1 = num / den;
                if (!(fabs(0.01 - freq1) > K_EPSILON)) {  // NaN -> done
                    break;
                }
            } else {
                freq2 = num / den;
                freq1 = freq2;
            }
        }
        maf[s] = freq1;
        // conv_space(exp) + E[G] (ngsLD.cpp:107-114)
        for (int64_t i = 0; i < I; i++) {
            const double* g = base + i * 3;
            double* o = gn + (s * I + i) * 3;
            o[0] = exp(g[0]); o[1] = exp(g[1]); o[2] = exp(g[2]);
            eg[s * I + i] = o[1] + 2.0 * o[2];
        }
    }
    return 0;
}

// Threaded siteprep: sites partition across workers (each site's outputs
// are independent, so results are byte-identical at any thread count).
// Returns nonzero if any slice hit the reference's NaN error.
int ngsld_strict_siteprep_mt(double* rows, int64_t m, int64_t I,
                             int in_logscale, int text_norm, int call_geno,
                             double N_thresh, double call_thresh,
                             int ignore_miss, double* gn, double* maf,
                             double* eg, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if ((int64_t)n_threads > m) n_threads = (int)(m ? m : 1);
    if (n_threads == 1)
        return ngsld_strict_siteprep(rows, m, I, in_logscale, text_norm,
                                     call_geno, N_thresh, call_thresh,
                                     ignore_miss, gn, maf, eg);
    std::vector<int> rcs((size_t)n_threads, 0);
    auto work = [&](int t) {
        int64_t lo = m * t / n_threads;
        int64_t hi = m * (t + 1) / n_threads;
        if (hi <= lo) return;
        rcs[(size_t)t] = ngsld_strict_siteprep(
            rows + lo * I * 3, hi - lo, I, in_logscale, text_norm,
            call_geno, N_thresh, call_thresh, ignore_miss,
            gn + lo * I * 3, maf + lo, eg + lo * I);
    };
    std::vector<std::thread> ths;
    for (int t = 1; t < n_threads; t++) ths.emplace_back(work, t);
    work(0);
    for (auto& th : ths) th.join();
    for (int r : rcs) if (r) return r;
    return 0;
}

// Bit-exact pair_freq_iter (gen_func.cpp:1027-1119 / strict.pair_em_batch)
// over k pairs: gn1/gn2 (k, I, 3) NORMAL-space GLs, maf1/maf2 (k,).
// Outputs f (k, 4), n_iter (k,), n_used (k,).
// Lane-parallel variant: VW pairs advance together, each lane replaying
// the scalar sequence EXACTLY (its own 16-term kk-major fold, its own
// sequential in-place normalization, its own break point — frozen lanes
// keep their converged f while the group finishes). Per-lane IEEE f64
// ops are bit-identical to the scalar path (the build forbids fma
// contraction), so results match ngsld_strict_pair_em bit-for-bit; the
// win is throughput on the refine tier's DEGENERATE pairs, which run at
// or near ITER_MAX (r5 profile: the strict EM was ~half the knife-edge
// repair wall). Group GLs transpose once into lane-major scratch so the
// hot loop reads contiguous VW-vectors.
#define VW 8
#if defined(__AVX512F__)
#include <immintrin.h>
// One EM iteration's individual loop, 8 pairs per zmm lane set.
// Every op mirrors the scalar sequence per lane (mul/add/div in the
// exact fold order, no fma); the masked add IS the scalar
// ignore-missing `continue` (untouched lanes keep their ff).
static inline void em_iter_lanes(
        const double* __restrict A, const double* __restrict B,
        const double* __restrict inc, int64_t I,
        const double f[4][VW], double ffout[4][VW]) {
    const __m512d zero = _mm512_setzero_pd();
    __m512d fv0 = _mm512_loadu_pd(f[0]), fv1 = _mm512_loadu_pd(f[1]),
            fv2 = _mm512_loadu_pd(f[2]), fv3 = _mm512_loadu_pd(f[3]);
    __m512d ff0 = zero, ff1 = zero, ff2 = zero, ff3 = zero;
    const __m512d fp00 = _mm512_mul_pd(fv0, fv0);
    const __m512d fp01 = _mm512_mul_pd(fv0, fv1);
    const __m512d fp02 = _mm512_mul_pd(fv0, fv2);
    const __m512d fp03 = _mm512_mul_pd(fv0, fv3);
    const __m512d fp10 = _mm512_mul_pd(fv1, fv0);
    const __m512d fp11 = _mm512_mul_pd(fv1, fv1);
    const __m512d fp12 = _mm512_mul_pd(fv1, fv2);
    const __m512d fp13 = _mm512_mul_pd(fv1, fv3);
    const __m512d fp20 = _mm512_mul_pd(fv2, fv0);
    const __m512d fp21 = _mm512_mul_pd(fv2, fv1);
    const __m512d fp22 = _mm512_mul_pd(fv2, fv2);
    const __m512d fp23 = _mm512_mul_pd(fv2, fv3);
    const __m512d fp30 = _mm512_mul_pd(fv3, fv0);
    const __m512d fp31 = _mm512_mul_pd(fv3, fv1);
    const __m512d fp32 = _mm512_mul_pd(fv3, fv2);
    const __m512d fp33 = _mm512_mul_pd(fv3, fv3);
    for (int64_t i = 0; i < I; i++) {
        __m512d a0 = _mm512_loadu_pd(A + (i * 3 + 0) * VW);
        __m512d a1 = _mm512_loadu_pd(A + (i * 3 + 1) * VW);
        __m512d a2 = _mm512_loadu_pd(A + (i * 3 + 2) * VW);
        __m512d b0 = _mm512_loadu_pd(B + (i * 3 + 0) * VW);
        __m512d b1 = _mm512_loadu_pd(B + (i * 3 + 1) * VW);
        __m512d b2 = _mm512_loadu_pd(B + (i * 3 + 2) * VW);
        __mmask8 m = _mm512_cmp_pd_mask(
            _mm512_loadu_pd(inc + i * VW), zero, _CMP_NEQ_OQ);
        __m512d sum = _mm512_mul_pd(_mm512_mul_pd(fp00, a0), b0);
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp01, a0), b1));
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp02, a1), b0));
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp03, a1), b1));
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp10, a0), b1));
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp11, a0), b2));
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp12, a1), b1));
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp13, a1), b2));
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp20, a1), b0));
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp21, a1), b1));
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp22, a2), b0));
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp23, a2), b1));
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp30, a1), b1));
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp31, a1), b2));
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp32, a2), b1));
        sum = _mm512_add_pd(sum, _mm512_mul_pd(_mm512_mul_pd(fp33, a2), b2));
        __m512d u00 = _mm512_mul_pd(a0, b0);
        u00 = _mm512_add_pd(u00, u00);
        u00 = _mm512_mul_pd(u00, fp00);
        __m512d t0 = u00;
        __m512d u01 = _mm512_mul_pd(a0, b1);
        u01 = _mm512_add_pd(u01, u01);
        u01 = _mm512_mul_pd(u01, fp01);
        t0 = _mm512_add_pd(t0, u01);
        __m512d u02 = _mm512_mul_pd(a1, b0);
        u02 = _mm512_add_pd(u02, u02);
        u02 = _mm512_mul_pd(u02, fp02);
        t0 = _mm512_add_pd(t0, u02);
        __m512d u03 = _mm512_mul_pd(a1, b1);
        u03 = _mm512_add_pd(u03, u03);
        u03 = _mm512_mul_pd(u03, fp03);
        t0 = _mm512_add_pd(t0, u03);
        ff0 = _mm512_mask_add_pd(ff0, m, ff0, _mm512_div_pd(t0, sum));
        __m512d u10 = _mm512_mul_pd(a0, b1);
        u10 = _mm512_add_pd(u10, u10);
        u10 = _mm512_mul_pd(u10, fp10);
        __m512d t1 = u10;
        __m512d u11 = _mm512_mul_pd(a0, b2);
        u11 = _mm512_add_pd(u11, u11);
        u11 = _mm512_mul_pd(u11, fp11);
        t1 = _mm512_add_pd(t1, u11);
        __m512d u12 = _mm512_mul_pd(a1, b1);
        u12 = _mm512_add_pd(u12, u12);
        u12 = _mm512_mul_pd(u12, fp12);
        t1 = _mm512_add_pd(t1, u12);
        __m512d u13 = _mm512_mul_pd(a1, b2);
        u13 = _mm512_add_pd(u13, u13);
        u13 = _mm512_mul_pd(u13, fp13);
        t1 = _mm512_add_pd(t1, u13);
        ff1 = _mm512_mask_add_pd(ff1, m, ff1, _mm512_div_pd(t1, sum));
        __m512d u20 = _mm512_mul_pd(a1, b0);
        u20 = _mm512_add_pd(u20, u20);
        u20 = _mm512_mul_pd(u20, fp20);
        __m512d t2 = u20;
        __m512d u21 = _mm512_mul_pd(a1, b1);
        u21 = _mm512_add_pd(u21, u21);
        u21 = _mm512_mul_pd(u21, fp21);
        t2 = _mm512_add_pd(t2, u21);
        __m512d u22 = _mm512_mul_pd(a2, b0);
        u22 = _mm512_add_pd(u22, u22);
        u22 = _mm512_mul_pd(u22, fp22);
        t2 = _mm512_add_pd(t2, u22);
        __m512d u23 = _mm512_mul_pd(a2, b1);
        u23 = _mm512_add_pd(u23, u23);
        u23 = _mm512_mul_pd(u23, fp23);
        t2 = _mm512_add_pd(t2, u23);
        ff2 = _mm512_mask_add_pd(ff2, m, ff2, _mm512_div_pd(t2, sum));
        __m512d u30 = _mm512_mul_pd(a1, b1);
        u30 = _mm512_add_pd(u30, u30);
        u30 = _mm512_mul_pd(u30, fp30);
        __m512d t3 = u30;
        __m512d u31 = _mm512_mul_pd(a1, b2);
        u31 = _mm512_add_pd(u31, u31);
        u31 = _mm512_mul_pd(u31, fp31);
        t3 = _mm512_add_pd(t3, u31);
        __m512d u32 = _mm512_mul_pd(a2, b1);
        u32 = _mm512_add_pd(u32, u32);
        u32 = _mm512_mul_pd(u32, fp32);
        t3 = _mm512_add_pd(t3, u32);
        __m512d u33 = _mm512_mul_pd(a2, b2);
        u33 = _mm512_add_pd(u33, u33);
        u33 = _mm512_mul_pd(u33, fp33);
        t3 = _mm512_add_pd(t3, u33);
        ff3 = _mm512_mask_add_pd(ff3, m, ff3, _mm512_div_pd(t3, sum));
    }
    _mm512_storeu_pd(ffout[0], ff0);
    _mm512_storeu_pd(ffout[1], ff1);
    _mm512_storeu_pd(ffout[2], ff2);
    _mm512_storeu_pd(ffout[3], ff3);
}
#endif  // __AVX512F__

static void strict_pair_em_group(
        const double* __restrict gn1, const double* __restrict gn2,
        const double* __restrict maf1, const double* __restrict maf2,
        int ignore_miss, int64_t I, int nl,
        const int G1[4][4], const int G2[4][4],
        double* __restrict A, double* __restrict B,
        double* __restrict inc,                // (I, 3, VW) x2, (I, VW)
        double* __restrict f_out, int32_t* __restrict n_iter,
        int32_t* __restrict n_used) {
    for (int64_t i = 0; i < I; i++)
        for (int c = 0; c < 3; c++)
            for (int w = 0; w < VW; w++) {
                int wl = w < nl ? w : nl - 1;   // pad lanes mirror the last
                A[(i * 3 + c) * VW + w] = gn1[(wl * I + i) * 3 + c];
                B[(i * 3 + c) * VW + w] = gn2[(wl * I + i) * 3 + c];
            }
    double x[VW];
    for (int w = 0; w < VW; w++) x[w] = 0.0;
    for (int64_t i = 0; i < I; i++) {
        for (int w = 0; w < VW; w++) {
            double m = 0.0;
            if (ignore_miss) {
                const double* a = A + i * 3 * VW + w;
                const double* b = B + i * 3 * VW + w;
                int ma = fabs(a[0 * VW] - a[1 * VW]) < K_EPSILON
                    && fabs(a[1 * VW] - a[2 * VW]) < K_EPSILON;
                int mb = fabs(b[0 * VW] - b[1 * VW]) < K_EPSILON
                    && fabs(b[1 * VW] - b[2 * VW]) < K_EPSILON;
                m = (ma || mb) ? 1.0 : 0.0;
            }
            inc[i * VW + w] = 1.0 - m;
            if (m == 0.0) x[w] += 1.0;
        }
    }
    double f[4][VW];
    for (int w = 0; w < VW; w++) {
        int wl = w < nl ? w : nl - 1;
        f[0][w] = (1 - maf1[wl]) * (1 - maf2[wl]);
        f[1][w] = (1 - maf1[wl]) * maf2[wl];
        f[2][w] = maf1[wl] * (1 - maf2[wl]);
        f[3][w] = maf1[wl] * maf2[wl];
    }
    double act[VW];
    int32_t nit[VW];
    for (int w = 0; w < VW; w++) { act[w] = 1.0; nit[w] = K_ITER_MAX; }
    for (int it = 0; it < K_ITER_MAX; it++) {
        int any = 0;
        for (int w = 0; w < VW; w++) any |= act[w] != 0.0;
        if (!any) break;
        double ff[4][VW];
#if defined(__AVX512F__)
        em_iter_lanes(A, B, inc, I, f, ff);
#else

        for (int kk = 0; kk < 4; kk++)
            for (int w = 0; w < VW; w++) ff[kk][w] = 0.0;
        for (int64_t i = 0; i < I; i++) {
            const double* __restrict a = A + i * 3 * VW;
            const double* __restrict b = B + i * 3 * VW;
            const double* __restrict iv = inc + i * VW;
// 16-term fold fully unrolled with CONSTANT genotype indices
            // (G1/G2 are symmetric: u and v of the reference's two
            // orderings coincide bit-for-bit, gen_func.cpp:1099-1104;
            // u+v is emitted as u+u on the identical value) so the
            // w-loop body is straight-line lane math the vectorizer
            // maps to 8-wide zmm ops — the loop-variant f[h][w]
            // accesses of the rolled form defeated it
#pragma omp simd
            for (int w = 0; w < VW; w++) {
                double f0 = f[0][w], f1 = f[1][w], f2 = f[2][w], f3 = f[3][w];
                double a0 = a[0 * VW + w], a1 = a[1 * VW + w], a2 = a[2 * VW + w];
                double b0 = b[0 * VW + w], b1 = b[1 * VW + w], b2 = b[2 * VW + w];
                double fp00 = f0 * f0;
                double fp01 = f0 * f1;
                double fp02 = f0 * f2;
                double fp03 = f0 * f3;
                double fp10 = f1 * f0;
                double fp11 = f1 * f1;
                double fp12 = f1 * f2;
                double fp13 = f1 * f3;
                double fp20 = f2 * f0;
                double fp21 = f2 * f1;
                double fp22 = f2 * f2;
                double fp23 = f2 * f3;
                double fp30 = f3 * f0;
                double fp31 = f3 * f1;
                double fp32 = f3 * f2;
                double fp33 = f3 * f3;
                double sum = (fp00 * a0) * b0;
                sum += (fp01 * a0) * b1;
                sum += (fp02 * a1) * b0;
                sum += (fp03 * a1) * b1;
                sum += (fp10 * a0) * b1;
                sum += (fp11 * a0) * b2;
                sum += (fp12 * a1) * b1;
                sum += (fp13 * a1) * b2;
                sum += (fp20 * a1) * b0;
                sum += (fp21 * a1) * b1;
                sum += (fp22 * a2) * b0;
                sum += (fp23 * a2) * b1;
                sum += (fp30 * a1) * b1;
                sum += (fp31 * a1) * b2;
                sum += (fp32 * a2) * b1;
                sum += (fp33 * a2) * b2;
                double t0;
                { double u = a0 * b0; u += u; u *= fp00; t0 = u; }
                { double u = a0 * b1; u += u; u *= fp01; t0 += u; }
                { double u = a1 * b0; u += u; u *= fp02; t0 += u; }
                { double u = a1 * b1; u += u; u *= fp03; t0 += u; }
                double q0 = t0 / sum;
                ff[0][w] += iv[w] != 0.0 ? q0 : 0.0;
                double t1;
                { double u = a0 * b1; u += u; u *= fp10; t1 = u; }
                { double u = a0 * b2; u += u; u *= fp11; t1 += u; }
                { double u = a1 * b1; u += u; u *= fp12; t1 += u; }
                { double u = a1 * b2; u += u; u *= fp13; t1 += u; }
                double q1 = t1 / sum;
                ff[1][w] += iv[w] != 0.0 ? q1 : 0.0;
                double t2;
                { double u = a1 * b0; u += u; u *= fp20; t2 = u; }
                { double u = a1 * b1; u += u; u *= fp21; t2 += u; }
                { double u = a2 * b0; u += u; u *= fp22; t2 += u; }
                { double u = a2 * b1; u += u; u *= fp23; t2 += u; }
                double q2 = t2 / sum;
                ff[2][w] += iv[w] != 0.0 ? q2 : 0.0;
                double t3;
                { double u = a1 * b1; u += u; u *= fp30; t3 = u; }
                { double u = a1 * b2; u += u; u *= fp31; t3 += u; }
                { double u = a2 * b1; u += u; u *= fp32; t3 += u; }
                { double u = a2 * b2; u += u; u *= fp33; t3 += u; }
                double q3 = t3 / sum;
                ff[3][w] += iv[w] != 0.0 ? q3 : 0.0;
            }
                }
#endif
        for (int w = 0; w < VW; w++) {
            if (act[w] == 0.0) continue;
            double two_x = 2.0 * x[w];
            double fn[4];
            for (int kk = 0; kk < 4; kk++) fn[kk] = ff[kk][w] / two_x;
            for (int kk = 0; kk < 4; kk++) {
                double denom = ((fn[0] + fn[1]) + fn[2]) + fn[3];
                fn[kk] = fn[kk] / denom;
            }
            double eps = 0.0;
            for (int kk = 0; kk < 4; kk++) {
                double d = fabs(fn[kk] - f[kk][w]);
                if (d > eps) eps = d;
            }
            for (int kk = 0; kk < 4; kk++) f[kk][w] = fn[kk];
            if (eps < K_EPSILON) { nit[w] = it; act[w] = 0.0; }
        }
    }
    for (int w = 0; w < nl; w++) {
        n_used[w] = (int32_t)x[w];
        n_iter[w] = nit[w];
        for (int kk = 0; kk < 4; kk++) f_out[w * 4 + kk] = f[kk][w];
    }
}

void ngsld_strict_pair_em(const double* gn1, const double* gn2,
                          const double* maf1, const double* maf2,
                          int ignore_miss, int64_t k, int64_t I,
                          double* f_out, int32_t* n_iter,
                          int32_t* n_used) {
    {
        // lane-parallel fast path (bit-identical; see above)
        int G1[4][4], G2[4][4];
        for (int a = 0; a < 4; a++)
            for (int h = 0; h < 4; h++) {
                G1[a][h] = (a >> 1) + (h >> 1);
                G2[a][h] = (a & 1) + (h & 1);
            }
        std::vector<double> A(I * 3 * VW), B(I * 3 * VW), inc(I * VW);
        for (int64_t p0 = 0; p0 < k; p0 += VW) {
            int nl = (int)((k - p0) < VW ? (k - p0) : VW);
            strict_pair_em_group(
                gn1 + p0 * I * 3, gn2 + p0 * I * 3, maf1 + p0,
                maf2 + p0, ignore_miss, I, nl, G1, G2,
                A.data(), B.data(), inc.data(),
                f_out + p0 * 4, n_iter + p0, n_used + p0);
        }
    }
}

// Threaded front-end: pairs partition across worker threads, each
// running the lane-parallel path on its slice. Results are
// partition-invariant (lanes never interact — grouping affects only
// execution time), so any thread count produces byte-identical output;
// tests pin _mt == single-thread == scalar. On a 1-core host this is a
// pass-through.
void ngsld_strict_pair_em_mt(const double* gn1, const double* gn2,
                             const double* maf1, const double* maf2,
                             int ignore_miss, int64_t k, int64_t I,
                             double* f_out, int32_t* n_iter,
                             int32_t* n_used, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if ((int64_t)n_threads > k) n_threads = (int)(k ? k : 1);
    if (n_threads == 1) {
        ngsld_strict_pair_em(gn1, gn2, maf1, maf2, ignore_miss, k, I,
                             f_out, n_iter, n_used);
        return;
    }
    auto work = [&](int t) {
        int64_t lo = k * t / n_threads;
        int64_t hi = k * (t + 1) / n_threads;
        if (hi <= lo) return;
        ngsld_strict_pair_em(gn1 + lo * I * 3, gn2 + lo * I * 3,
                             maf1 + lo, maf2 + lo, ignore_miss,
                             hi - lo, I, f_out + lo * 4, n_iter + lo,
                             n_used + lo);
    };
    std::vector<std::thread> ths;
    for (int t = 1; t < n_threads; t++) ths.emplace_back(work, t);
    work(0);
    for (auto& th : ths) th.join();
}

// The original one-pair-at-a-time loop, kept as the verification oracle
// for the lane-parallel path above (tests pin byte equality).
void ngsld_strict_pair_em_scalar(const double* gn1, const double* gn2,
                                 const double* maf1, const double* maf2,
                                 int ignore_miss, int64_t k, int64_t I,
                                 double* f_out, int32_t* n_iter,
                                 int32_t* n_used) {
    // genotype-sum index maps (gen_func.cpp:1073-1074)
    int G1[4][4], G2[4][4];
    for (int a = 0; a < 4; a++)
        for (int h = 0; h < 4; h++) {
            G1[a][h] = (a >> 1) + (h >> 1);
            G2[a][h] = (a & 1) + (h & 1);
        }
    for (int64_t p = 0; p < k; p++) {
        const double* s1 = gn1 + p * I * 3;
        const double* s2 = gn2 + p * I * 3;
        double f[4];
        f[0] = (1 - maf1[p]) * (1 - maf2[p]);
        f[1] = (1 - maf1[p]) * maf2[p];
        f[2] = maf1[p] * (1 - maf2[p]);
        f[3] = maf1[p] * maf2[p];
        int64_t x = 0;
        for (int64_t i = 0; i < I; i++) {
            int miss = 0;
            if (ignore_miss) {
                const double* a = s1 + i * 3;
                const double* b = s2 + i * 3;
                int ma = fabs(a[0] - a[1]) < K_EPSILON
                    && fabs(a[1] - a[2]) < K_EPSILON;
                int mb = fabs(b[0] - b[1]) < K_EPSILON
                    && fabs(b[1] - b[2]) < K_EPSILON;
                miss = ma || mb;
            }
            if (!miss) x++;
        }
        n_used[p] = (int32_t)x;
        int it_done = K_ITER_MAX;
        for (int it = 0; it < K_ITER_MAX; it++) {
            double ff[4] = {0.0, 0.0, 0.0, 0.0};
            for (int64_t i = 0; i < I; i++) {
                const double* a = s1 + i * 3;
                const double* b = s2 + i * 3;
                if (ignore_miss) {
                    int ma = fabs(a[0] - a[1]) < K_EPSILON
                        && fabs(a[1] - a[2]) < K_EPSILON;
                    int mb = fabs(b[0] - b[1]) < K_EPSILON
                        && fabs(b[1] - b[2]) < K_EPSILON;
                    if (ma || mb) continue;
                }
                // SUM: 16 sequential ((f[kk]*f[h])*g1)*g2 terms in
                // kk-major, h-minor order (gen_func.cpp:1094-1097)
                double sum = 0.0;
                for (int kk = 0; kk < 4; kk++)
                    for (int h = 0; h < 4; h++)
                        sum += ((f[kk] * f[h]) * a[G1[kk][h]])
                            * b[G2[kk][h]];
                // TMP_k: 4 sequential (g~ + g~) * (f[kk]*f[h]) terms
                // (gen_func.cpp:1099-1104), then the sequential fold of
                // tmp/sum over individuals (gen_func.cpp:1106)
                for (int kk = 0; kk < 4; kk++) {
                    double tmp = 0.0;
                    for (int h = 0; h < 4; h++) {
                        double u = a[G1[h][kk]] * b[G2[h][kk]];
                        double v = a[G1[kk][h]] * b[G2[kk][h]];
                        u += v;
                        u *= (f[kk] * f[h]);
                        tmp += u;
                    }
                    ff[kk] += tmp / sum;
                }
            }
            // f_k = ff_k / (2x), then the in-place sequential
            // normalization where k's denominator sees already-
            // normalized f[0..k-1] (gen_func.cpp:1109-1113)
            double two_x = 2.0 * (double)x;
            double fn[4];
            for (int kk = 0; kk < 4; kk++) fn[kk] = ff[kk] / two_x;
            for (int kk = 0; kk < 4; kk++) {
                double denom = ((fn[0] + fn[1]) + fn[2]) + fn[3];
                fn[kk] = fn[kk] / denom;
            }
            // eps = fold of `if (d > eps) eps = d` (NaN diffs skipped,
            // gen_func.cpp:1048-1052)
            double eps = 0.0;
            for (int kk = 0; kk < 4; kk++) {
                double d = fabs(fn[kk] - f[kk]);
                if (d > eps) eps = d;
            }
            f[0] = fn[0]; f[1] = fn[1]; f[2] = fn[2]; f[3] = fn[3];
            if (eps < K_EPSILON) { it_done = it; break; }
        }
        n_iter[p] = (int32_t)it_done;
        f_out[p * 4 + 0] = f[0];
        f_out[p * 4 + 1] = f[1];
        f_out[p * 4 + 2] = f[2];
        f_out[p * 4 + 3] = f[3];
    }
}

}  // extern "C"
