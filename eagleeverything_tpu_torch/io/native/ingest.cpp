// Native host-side genotype ingest — the TPU-VM CPU replacement for the
// reference's Rcpp/Eigen ingest kernels (createM_ASCII_rcpp / createMt /
// ReadBlock; SURVEY.md §3.3). Parsing and recoding are the ingest
// bottleneck for multi-GB text genotypes, so this is C++: mmap'd input,
// a line index, and multithreaded per-row recode into caller-provided
// int8 buffers. Exposed as a plain C ABI consumed via ctypes
// (io/native.py); the numpy-vectorized Python parsers remain the
// always-available fallback.
//
// Build: g++ -O3 -shared -fPIC -pthread ingest.cpp -o libeagleingest.so

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int8_t kMissing = -9;

struct MappedFile {
  int fd = -1;
  const char* data = nullptr;
  size_t size = 0;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); return false; }
    size = static_cast<size_t>(st.st_size);
    if (size == 0) { data = nullptr; return true; }
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) { ::close(fd); return false; }
    madvise(p, size, MADV_SEQUENTIAL);
    data = static_cast<const char*>(p);
    return true;
  }
  void close() {
    if (data) munmap(const_cast<char*>(data), size);
    if (fd >= 0) ::close(fd);
    data = nullptr; fd = -1; size = 0;
  }
};

// Find [start, end) of each nonempty line.
void index_lines(const char* data, size_t size,
                 std::vector<std::pair<size_t, size_t>>* lines) {
  size_t pos = 0;
  while (pos < size) {
    size_t start = pos;
    const char* nl = static_cast<const char*>(
        memchr(data + pos, '\n', size - pos));
    size_t end = nl ? static_cast<size_t>(nl - data) : size;
    size_t trimmed = end;
    while (trimmed > start &&
           (data[trimmed - 1] == '\r' || data[trimmed - 1] == ' ')) {
      --trimmed;
    }
    if (trimmed > start) lines->emplace_back(start, trimmed);
    pos = end + 1;
  }
}

struct Codes {
  std::string aa, ab, bb, miss;
};

// Recode one spaced-token line into out[0..p). Returns number of tokens
// parsed, or -1 on an unrecognized token.
int64_t recode_spaced_line(const char* s, const char* e, const Codes& c,
                           int8_t* out, int64_t p) {
  int64_t j = 0;
  const size_t la = c.aa.size(), lb = c.ab.size(), lc = c.bb.size(),
               lm = c.miss.size();
  while (s < e) {
    while (s < e && (*s == ' ' || *s == '\t')) ++s;
    if (s >= e) break;
    const char* tok = s;
    while (s < e && *s != ' ' && *s != '\t') ++s;
    size_t len = static_cast<size_t>(s - tok);
    if (j >= p) return -1;
    int8_t v;
    if (len == la && memcmp(tok, c.aa.data(), la) == 0) v = 0;
    else if (len == lb && memcmp(tok, c.ab.data(), lb) == 0) v = 1;
    else if (len == lc && memcmp(tok, c.bb.data(), lc) == 0) v = 2;
    else if (len == lm && memcmp(tok, c.miss.data(), lm) == 0) v = kMissing;
    else return -1;
    out[j++] = v;
  }
  return j;
}

constexpr int8_t kInvalid = -128;

void build_char_lut(const Codes& c, int8_t lut[256]) {
  // unknown characters are ERRORS, matching the spaced-token path —
  // silent missing-coercion would bias the kernel with no diagnostic
  for (int i = 0; i < 256; ++i) lut[i] = kInvalid;
  lut[static_cast<unsigned char>(c.aa[0])] = 0;
  lut[static_cast<unsigned char>(c.ab[0])] = 1;
  lut[static_cast<unsigned char>(c.bb[0])] = 2;
  if (c.miss.size() == 1)
    lut[static_cast<unsigned char>(c.miss[0])] = kMissing;
}

int hw_threads() {
  // EE_NCPU caps the recode thread pool — the reference's `ncpu` knob
  // (SURVEY.md §3.4 row 1); unset/0 → all hardware threads.
  if (const char* env = std::getenv("EE_NCPU")) {
    int v = std::atoi(env);
    if (v > 0) return v;
  }
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

struct Stream {
  MappedFile mf;
  std::vector<std::pair<size_t, size_t>> lines;
  size_t next_line = 0;
  Codes codes;
  int nospace = 0;
  int64_t p = 0;
};

int64_t count_cols(const Stream* st) {
  if (st->lines.empty()) return 0;
  const char* s = st->mf.data + st->lines[0].first;
  const char* e = st->mf.data + st->lines[0].second;
  if (st->nospace) return e - s;
  int64_t cols = 0;
  while (s < e) {
    while (s < e && (*s == ' ' || *s == '\t')) ++s;
    if (s >= e) break;
    ++cols;
    while (s < e && *s != ' ' && *s != '\t') ++s;
  }
  return cols;
}

// Parallel recode of line range [row0, row0+rows) into out (rows × p).
int recode_rows(const Stream* st, size_t row0, int64_t rows, int8_t* out) {
  const int nt = std::min<int64_t>(hw_threads(), std::max<int64_t>(rows, 1));
  std::vector<std::thread> threads;
  std::vector<int64_t> errs(nt, 0);
  int8_t lut[256];
  if (st->nospace) build_char_lut(st->codes, lut);
  const int64_t chunk = (rows + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      const int64_t lo = t * chunk, hi = std::min<int64_t>(rows, lo + chunk);
      for (int64_t r = lo; r < hi; ++r) {
        const auto& ln = st->lines[row0 + r];
        const char* s = st->mf.data + ln.first;
        const char* e = st->mf.data + ln.second;
        int8_t* dst = out + r * st->p;
        if (st->nospace) {
          if (e - s != st->p) { errs[t] = r + 1; return; }
          for (int64_t j = 0; j < st->p; ++j) {
            const int8_t v = lut[static_cast<unsigned char>(s[j])];
            if (v == kInvalid) { errs[t] = r + 1; return; }
            dst[j] = v;
          }
        } else {
          if (recode_spaced_line(s, e, st->codes, dst, st->p) != st->p) {
            errs[t] = r + 1; return;
          }
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < nt; ++t)
    if (errs[t]) return static_cast<int>(-errs[t]);
  return 0;
}

// ---------------------------------------------------------------------------
// VCF GT scanner — the native fast path for ReadMarker(type='vcf')
// (reference: the VCF branch of ReadMarker, SURVEY.md §3.3 "VCF ingest";
// ingest throughput on multi-million-SNP VCFs is flagged as a hot spot in
// SURVEY.md §8). Semantics mirror parsers.iter_vcf_blocks exactly: only the
// GT subfield is read; '.' anywhere in the call or <2 alleles → missing;
// allele doses are clamped to 1 (multi-allelic → dose of the ALT count).

struct VcfStream {
  MappedFile mf;
  std::vector<std::pair<size_t, size_t>> lines;  // data lines only
  size_t next_line = 0;
  int64_t n_samples = 0;
};

constexpr int kChromW = 64;   // fixed-width metadata slots (per variant)
constexpr int kIdW = 128;

// Parse one data line. Returns 0 on success, -1 on any malformed or
// oversized record (caller reports the row; semantics match the Python
// parser raising on the same inputs).
int parse_vcf_row(const char* s, const char* e, int64_t n, int8_t* dose,
                  int64_t* pos, char* chrom, char* id) {
  // fields 0..8: CHROM POS ID REF ALT QUAL FILTER INFO FORMAT
  const char* f[9];
  const char* fe[9];
  const char* q = s;
  for (int k = 0; k < 9; ++k) {
    f[k] = q;
    const char* t = static_cast<const char*>(memchr(q, '\t', e - q));
    if (!t) return -1;  // needs ≥ 9 tabs (FORMAT + ≥1 sample)
    fe[k] = t;
    q = t + 1;
  }
  // CHROM / ID metadata (fixed-width, NUL-padded)
  if (fe[0] - f[0] >= kChromW || fe[2] - f[2] >= kIdW) return -1;
  memset(chrom, 0, kChromW);
  memcpy(chrom, f[0], fe[0] - f[0]);
  memset(id, 0, kIdW);
  memcpy(id, f[2], fe[2] - f[2]);
  // POS (digits only)
  int64_t p = 0;
  if (f[1] == fe[1]) return -1;
  for (const char* c = f[1]; c < fe[1]; ++c) {
    if (*c < '0' || *c > '9') return -1;
    p = p * 10 + (*c - '0');
  }
  *pos = p;
  // GT index within FORMAT (colon-separated keys)
  int gt_idx = -1, k = 0;
  for (const char* c = f[8]; c <= fe[8]; ++k) {
    const char* colon = static_cast<const char*>(
        memchr(c, ':', fe[8] - c));
    const char* tok_e = colon ? colon : fe[8];
    if (tok_e - c == 2 && c[0] == 'G' && c[1] == 'T') { gt_idx = k; break; }
    if (!colon) break;
    c = colon + 1;
  }
  if (gt_idx < 0) return -1;
  // samples
  for (int64_t i = 0; i < n; ++i) {
    if (q > e) return -1;  // fewer sample fields than samples
    const char* t = static_cast<const char*>(memchr(q, '\t', e - q));
    const char* se = t ? t : e;
    // gt_idx'th colon-separated subfield
    const char* g = q;
    for (int j = 0; j < gt_idx; ++j) {
      const char* colon = static_cast<const char*>(memchr(g, ':', se - g));
      if (!colon) return -1;  // truncated sample field (Python: IndexError)
      g = colon + 1;
    }
    const char* colon = static_cast<const char*>(memchr(g, ':', se - g));
    const char* ge = colon ? colon : se;
    // split alleles on '/' or '|'; mirror Python: any token "." or <2
    // tokens → missing; first two tokens must be numeric, clamped to 1
    int ntok = 0;
    bool any_dot = false, bad = false;
    int v01[2] = {0, 0};
    const char* a = g;
    while (a <= ge) {
      const char* sep = a;
      while (sep < ge && *sep != '/' && *sep != '|') ++sep;
      const int64_t len = sep - a;
      if (len == 1 && *a == '.') {
        any_dot = true;
      } else if (ntok < 2) {
        if (len == 0) { bad = true; }
        else {
          int64_t v = 0;
          for (const char* c = a; c < sep; ++c) {
            if (*c < '0' || *c > '9') { bad = true; break; }
            v = v * 10 + (*c - '0');
          }
          v01[ntok] = v > 0 ? 1 : 0;
        }
      }
      ++ntok;
      if (sep >= ge) break;
      a = sep + 1;
    }
    if (any_dot || ntok < 2) {
      dose[i] = kMissing;
    } else if (bad) {
      return -1;  // Python: int('') / int(garbage) raises
    } else {
      dose[i] = static_cast<int8_t>(v01[0] + v01[1]);
    }
    q = se + 1;
  }
  if (q <= e) return -1;  // more sample fields than samples
  return 0;
}

}  // namespace

extern "C" {

// Open a VCF for streamed GT scanning. Fills n_samples / n_variants.
// Returns nullptr on unreadable file or missing #CHROM header (callers
// fall back to the Python parser, which raises the descriptive error).
void* ee_vcf_open(const char* path, int64_t* n_samples,
                  int64_t* n_variants) {
  auto* st = new VcfStream();
  if (!st->mf.open(path)) { delete st; return nullptr; }
  std::vector<std::pair<size_t, size_t>> all;
  index_lines(st->mf.data, st->mf.size, &all);
  size_t first_data = 0;
  int64_t n = -1;
  for (size_t i = 0; i < all.size(); ++i) {
    const char* s = st->mf.data + all[i].first;
    const size_t len = all[i].second - all[i].first;
    if (len >= 2 && s[0] == '#' && s[1] == '#') continue;
    if (len >= 6 && memcmp(s, "#CHROM", 6) == 0) {
      n = 0;  // samples = tab-separated fields beyond the 9 fixed ones
      int64_t fields = 1;
      for (size_t j = 0; j < len; ++j) fields += (s[j] == '\t');
      n = fields - 9;
      first_data = i + 1;
      continue;
    }
    if (n < 0) { st->mf.close(); delete st; return nullptr; }
    if (first_data == 0) first_data = i;
    // metadata-width pre-check: CHROM/ID wider than the fixed slots is
    // legal VCF the native path can't represent — decline the whole file
    // here so callers use the Python parser (no mid-stream failure)
    const char* e = st->mf.data + all[i].second;
    const char* t1 = static_cast<const char*>(memchr(s, '\t', e - s));
    if (!t1 || t1 - s >= kChromW) {
      st->mf.close(); delete st; return nullptr;
    }
    const char* t2 = static_cast<const char*>(memchr(t1 + 1, '\t', e - t1 - 1));
    const char* t3 = t2 ? static_cast<const char*>(
        memchr(t2 + 1, '\t', e - t2 - 1)) : nullptr;
    if (!t3 || t3 - t2 - 1 >= kIdW) {
      st->mf.close(); delete st; return nullptr;
    }
  }
  if (n <= 0) { st->mf.close(); delete st; return nullptr; }
  st->lines.assign(all.begin() + first_data, all.end());
  st->n_samples = n;
  *n_samples = n;
  *n_variants = static_cast<int64_t>(st->lines.size());
  return st;
}

// Scan the next ≤ max_rows variants: doses (max_rows × n_samples int8,
// SNP-major), pos (int64), chrom/id (fixed 64/128-byte NUL-padded slots
// per variant). Returns variants produced (0 at EOF) or a negative
// 1-based row offset of the first malformed record within this block.
int64_t ee_vcf_next(void* handle, int8_t* doses, int64_t* pos, char* chrom,
                    char* id, int64_t max_rows) {
  auto* st = static_cast<VcfStream*>(handle);
  const int64_t remaining =
      static_cast<int64_t>(st->lines.size() - st->next_line);
  const int64_t rows = std::min(max_rows, remaining);
  if (rows <= 0) return 0;
  const int nt = std::min<int64_t>(hw_threads(), rows);
  const int64_t chunk = (rows + nt - 1) / nt;
  std::vector<std::thread> threads;
  std::vector<int64_t> errs(nt, 0);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      const int64_t lo = t * chunk, hi = std::min<int64_t>(rows, lo + chunk);
      for (int64_t r = lo; r < hi; ++r) {
        const auto& ln = st->lines[st->next_line + r];
        if (parse_vcf_row(st->mf.data + ln.first, st->mf.data + ln.second,
                          st->n_samples, doses + r * st->n_samples,
                          pos + r, chrom + r * kChromW, id + r * kIdW)
            != 0) {
          errs[t] = r + 1;
          return;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < nt; ++t)
    if (errs[t]) return -errs[t];
  st->next_line += static_cast<size_t>(rows);
  return rows;
}

void ee_vcf_close(void* handle) {
  auto* st = static_cast<VcfStream*>(handle);
  st->mf.close();
  delete st;
}

// Open an ASCII genotype file for streamed recoding. Returns an opaque
// handle (nullptr on failure) and fills n_rows / n_cols / nospace.
void* ee_ascii_open(const char* path, const char* aa, const char* ab,
                    const char* bb, const char* miss, int64_t* n_rows,
                    int64_t* n_cols, int* nospace) {
  auto* st = new Stream();
  st->codes = Codes{aa, ab, bb, miss};
  if (!st->mf.open(path)) { delete st; return nullptr; }
  index_lines(st->mf.data, st->mf.size, &st->lines);
  if (st->lines.empty()) { st->mf.close(); delete st; return nullptr; }
  // no-space mode: first line has no separators
  const char* s = st->mf.data + st->lines[0].first;
  const char* e = st->mf.data + st->lines[0].second;
  st->nospace = (memchr(s, ' ', e - s) == nullptr &&
                 memchr(s, '\t', e - s) == nullptr)
                    ? 1 : 0;
  st->p = count_cols(st);
  *n_rows = static_cast<int64_t>(st->lines.size());
  *n_cols = st->p;
  *nospace = st->nospace;
  return st;
}

// Recode the next ≤ max_rows rows into out (max_rows × p int8, row-major).
// Returns rows produced (0 at EOF), or a negative 1-based row offset of the
// first bad line within this block.
int64_t ee_ascii_next(void* handle, int8_t* out, int64_t max_rows) {
  auto* st = static_cast<Stream*>(handle);
  const int64_t remaining =
      static_cast<int64_t>(st->lines.size() - st->next_line);
  const int64_t rows = std::min(max_rows, remaining);
  if (rows <= 0) return 0;
  const int rc = recode_rows(st, st->next_line, rows, out);
  if (rc < 0) return rc;
  st->next_line += static_cast<size_t>(rows);
  return rows;
}

void ee_ascii_close(void* handle) {
  auto* st = static_cast<Stream*>(handle);
  st->mf.close();
  delete st;
}

// 2-bit genotype packing: {0,1,2} → codes 0,1,2; missing (-9) → 3.
// count = number of genotypes; output holds ceil(count/4) bytes.
void ee_pack2(const int8_t* in, uint8_t* out, int64_t count) {
  const int64_t nbytes = (count + 3) / 4;
  for (int64_t b = 0; b < nbytes; ++b) {
    uint8_t acc = 0;
    const int64_t base = b * 4;
    const int64_t lim = std::min<int64_t>(4, count - base);
    for (int64_t k = 0; k < lim; ++k) {
      int8_t v = in[base + k];
      uint8_t code = (v == kMissing) ? 3u : static_cast<uint8_t>(v);
      acc |= static_cast<uint8_t>(code << (2 * k));
    }
    out[b] = acc;
  }
}

void ee_unpack2(const uint8_t* in, int8_t* out, int64_t count) {
  for (int64_t i = 0; i < count; ++i) {
    uint8_t code = (in[i >> 2] >> (2 * (i & 3))) & 3u;
    out[i] = (code == 3u) ? kMissing : static_cast<int8_t>(code);
  }
}

}  // extern "C"
