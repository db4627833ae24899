// Native FASTA/FASTQ(.gz) parser + 2-bit encoder.
//
// The host-side analog of gatb-core's Bank layer (SURVEY.md §2.9):
// parses sequence files at IO speed and emits dense, device-ready
// uint8 code batches ([max_reads, max_len], 255-padded) so Python
// never touches individual reads. Exposed as a C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC fastx.cpp -o libfastx.so -lz

#include <zlib.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint8_t kInvalid = 255;

struct CodeTables {
  uint8_t acgt[256];
  uint8_t gatb[256];
  CodeTables() {
    memset(acgt, kInvalid, sizeof(acgt));
    memset(gatb, kInvalid, sizeof(gatb));
    const char* bases = "ACGT";
    const uint8_t gatb_codes[4] = {0, 1, 3, 2};  // A,C,G,T in gatb order
    for (int i = 0; i < 4; i++) {
      unsigned char u = bases[i];
      unsigned char l = u + 32;
      acgt[u] = acgt[l] = (uint8_t)i;
      gatb[u] = gatb[l] = gatb_codes[i];
    }
  }
};
const CodeTables kTables;

class FastxReader {
 public:
  explicit FastxReader(const char* path) : file_(gzopen(path, "rb")) {
    if (file_) {
      int c = gzgetc(file_);
      if (c != -1) gzungetc(c, file_);
      format_ = (c == '@') ? Format::kFastq : Format::kFasta;
      ok_ = (c == '>' || c == '@');
    }
  }
  ~FastxReader() {
    if (file_) gzclose(file_);
  }

  bool ok() const { return file_ && ok_; }

  // Reads the next sequence into seq_. Returns false at EOF or on a
  // malformed record (error() then holds a message -- silent
  // mis-parse is worse than a hard stop).
  bool next() {
    seq_.clear();
    if (!file_ || error_) return false;
    if (format_ == Format::kFasta) {
      // skip to the line after the next '>' header
      if (!have_header_ && !skip_header('>')) return false;
      have_header_ = false;
      while (read_line()) {
        if (!line_.empty() && line_[0] == '>') {
          have_header_ = true;
          return true;
        }
        append_line();
      }
      return !seq_.empty();
    }
    // FASTQ: @hdr / seq lines until '+' / qual lines until the
    // quality length matches the sequence length (the spec's
    // multi-line form; a quality line may START with '@' or '+', so
    // structure -- not markers -- terminates the record)
    for (;;) {  // tolerate blank lines between records
      if (!read_line()) return false;
      if (!line_.empty()) break;
    }
    record_++;
    if (line_[0] != '@') {
      fail("header does not start with '@'");
      return false;
    }
    bool saw_plus = false;
    while (read_line()) {
      if (!line_.empty() && line_[0] == '+') {
        saw_plus = true;
        break;
      }
      append_line();
    }
    if (!saw_plus) {
      fail("truncated record (missing '+' line)");
      return false;
    }
    size_t qlen = 0;
    while (qlen < seq_.size()) {
      if (!read_line()) {
        fail("truncated qualities");
        return false;
      }
      qlen += line_.size();
    }
    if (qlen != seq_.size()) {
      fail("quality length does not match sequence length");
      return false;
    }
    return true;
  }

  const std::string& seq() const { return seq_; }
  const char* error() const { return error_ ? errmsg_.c_str() : ""; }

  // One-read pushback so batch fillers can stop at a full buffer and
  // resume with the same read on the next call.
  bool pending = false;

 private:
  enum class Format { kFasta, kFastq };

  bool read_line() {
    line_.clear();
    char buf[4096];
    bool got = false;
    while (gzgets(file_, buf, sizeof(buf))) {
      got = true;
      size_t n = strlen(buf);
      bool end = n > 0 && buf[n - 1] == '\n';
      while (n > 0 && (buf[n - 1] == '\n' || buf[n - 1] == '\r')) n--;
      line_.append(buf, n);
      if (end) break;
    }
    return got;
  }

  bool skip_header(char mark) {
    if (have_header_) {
      have_header_ = false;
      return true;
    }
    while (read_line()) {
      if (!line_.empty() && line_[0] == mark) return true;
    }
    return false;
  }

  void append_line() { seq_.append(line_); }

  void fail(const char* what) {
    error_ = true;
    errmsg_ = "malformed FASTQ record " + std::to_string(record_) +
              ": " + what;
  }

  gzFile file_ = nullptr;
  Format format_ = Format::kFasta;
  bool ok_ = false;
  bool have_header_ = false;
  bool error_ = false;
  long record_ = 0;
  std::string errmsg_;
  std::string line_;
  std::string seq_;
};

// Shannon index over A/C/T/G/N bins, float32 stepping like the
// reference (SimkaCommons.hpp:393-432).
float shannon_index(const std::string& s) {
  static uint8_t bins[256];
  static bool init = false;
  if (!init) {
    memset(bins, 0, sizeof(bins));
    bins[(unsigned char)'C'] = 1;
    bins[(unsigned char)'T'] = 2;
    bins[(unsigned char)'G'] = 3;
    bins[(unsigned char)'N'] = 4;
    init = true;
  }
  if (s.empty()) return 0.f;
  float freqs[5] = {0, 0, 0, 0, 0};
  for (unsigned char c : s) freqs[bins[c]] += 1.f;
  float index = 0.f;
  for (int i = 0; i < 5; i++) {
    float f = freqs[i] / (float)s.size();
    if (f != 0) index += f * logf(f) / logf(2.f);
  }
  return index < 0 ? -index : index;
}

}  // namespace

extern "C" {

void* fastx_open(const char* path) {
  auto* r = new FastxReader(path);
  if (!r->ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

void fastx_close(void* handle) { delete static_cast<FastxReader*>(handle); }

// Non-empty after any batch call whose reader hit a malformed FASTQ
// record; the Python wrapper raises instead of silently truncating.
const char* fastx_error(void* handle) {
  return static_cast<FastxReader*>(handle)->error();
}

// Fills codes[max_reads * max_len] (row-major, 255-padded) and
// lengths[max_reads] with the next batch of filtered reads.
// encoding: 0 = ACGT(0123), 1 = gatb ACTG.
// Returns the number of reads written; 0 at EOF.
int64_t fastx_read_batch(void* handle, int64_t max_reads, int64_t max_len,
                         int32_t min_read_size, float min_shannon,
                         int32_t encoding, uint8_t* codes,
                         int32_t* lengths) {
  auto* r = static_cast<FastxReader*>(handle);
  const uint8_t* lut = encoding ? kTables.gatb : kTables.acgt;
  memset(codes, kInvalid, (size_t)max_reads * max_len);
  int64_t n = 0;
  while (n < max_reads && r->next()) {
    const std::string& s = r->seq();
    if (min_read_size && (int64_t)s.size() < min_read_size) continue;
    if (min_shannon != 0.f && shannon_index(s) < min_shannon) continue;
    int64_t len = (int64_t)s.size() < max_len ? (int64_t)s.size() : max_len;
    uint8_t* row = codes + n * max_len;
    for (int64_t i = 0; i < len; i++) row[i] = lut[(unsigned char)s[i]];
    lengths[n] = (int32_t)len;
    n++;
  }
  return n;
}

// Fills buf (capacity max_bytes) with the next batch of FILTERED reads
// as concatenated raw bytes; offsets[0..n] delimit them
// (offsets has capacity max_reads + 1, offsets[0] == 0).
// Returns n >= 1, 0 at EOF, or -needed_bytes when a single read is
// larger than the whole buffer (caller reallocates and retries).
int64_t fastx_read_raw_batch(void* handle, int64_t max_reads,
                             int64_t max_bytes, int32_t min_read_size,
                             float min_shannon, uint8_t* buf,
                             int64_t* offsets) {
  auto* r = static_cast<FastxReader*>(handle);
  int64_t n = 0;
  int64_t used = 0;
  offsets[0] = 0;
  while (n < max_reads) {
    if (r->pending) {
      r->pending = false;
    } else if (!r->next()) {
      break;
    }
    const std::string& s = r->seq();
    if (min_read_size && (int64_t)s.size() < min_read_size) continue;
    if (min_shannon != 0.f && shannon_index(s) < min_shannon) continue;
    if (used + (int64_t)s.size() > max_bytes) {
      r->pending = true;
      if (n == 0) return -(int64_t)s.size();
      break;
    }
    memcpy(buf + used, s.data(), s.size());
    used += (int64_t)s.size();
    offsets[++n] = used;
  }
  return n;
}

// Fills packed[max_reads * width/4] (2-bit codes, 4/byte, little
// pairs) and validbits[max_reads * width/8] (1 bit/base, little
// bitorder) with the next batch of filtered reads -- the exact layout
// of simka_tpu.ops.kmers.pack_codes_host, produced in ONE pass at
// parse time so Python never touches read bytes and the host->device
// copy carries 0.375 B/base. width must be a multiple of 8.
// *n_valid accumulates the number of valid k-mer windows (positions
// whose next kmer_size bases are all ACGT) across the batch's reads
// -- the device join can then be sliced to the true window count
// without a device sync (kmer_size <= 0 skips the count).
// Returns the number of reads written; 0 at EOF; -needed_width when a
// read is longer than width (caller re-calls with a wider buffer; the
// read is held pending).
int64_t fastx_read_packed_batch(void* handle, int64_t max_reads,
                                int64_t width, int32_t min_read_size,
                                float min_shannon, int32_t encoding,
                                int32_t kmer_size, uint8_t* packed,
                                uint8_t* validbits, int64_t* n_valid) {
  auto* r = static_cast<FastxReader*>(handle);
  const uint8_t* lut = encoding ? kTables.gatb : kTables.acgt;
  const int64_t wq = width / 4, wb = width / 8;
  memset(packed, 0, (size_t)max_reads * wq);
  memset(validbits, 0, (size_t)max_reads * wb);
  int64_t n = 0;
  while (n < max_reads) {
    if (r->pending) {
      r->pending = false;
    } else if (!r->next()) {
      break;
    }
    const std::string& s = r->seq();
    if (min_read_size && (int64_t)s.size() < min_read_size) continue;
    if (min_shannon != 0.f && shannon_index(s) < min_shannon) continue;
    if ((int64_t)s.size() > width) {
      r->pending = true;
      if (n == 0) return -(int64_t)s.size();
      break;
    }
    uint8_t* prow = packed + n * wq;
    uint8_t* vrow = validbits + n * wb;
    const int64_t len = (int64_t)s.size();
    int64_t run = 0;
    for (int64_t i = 0; i < len; i++) {
      uint8_t code = lut[(unsigned char)s[i]];
      if (code == kInvalid) {
        run = 0;
        continue;
      }
      prow[i >> 2] |= (uint8_t)(code << ((i & 3) * 2));
      vrow[i >> 3] |= (uint8_t)(1u << (i & 7));
      if (kmer_size > 0 && ++run >= kmer_size) (*n_valid)++;
    }
    n++;
  }
  return n;
}

// Counts reads (post-filter) without encoding.
int64_t fastx_count_reads(const char* path, int32_t min_read_size,
                          float min_shannon) {
  FastxReader r(path);
  if (!r.ok()) return -1;
  int64_t n = 0;
  while (r.next()) {
    const std::string& s = r.seq();
    if (min_read_size && (int64_t)s.size() < min_read_size) continue;
    if (min_shannon != 0.f && shannon_index(s) < min_shannon) continue;
    n++;
  }
  if (r.error()[0]) return -2;  // malformed FASTQ
  return n;
}

}  // extern "C"
