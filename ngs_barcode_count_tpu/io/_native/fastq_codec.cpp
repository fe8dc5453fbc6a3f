// Native FASTQ -> tensor encoder (this build's answer to the
// reference's reader thread, input.rs:24-159).
//
// The reference streams lines through a mutex deque at ~300k reads/s per
// core; feeding an accelerator at >3M reads/s needs the byte->tensor
// conversion to
// be memory-bandwidth bound, so this codec:
//   - scans newlines with a 16-byte-unrolled loop (memchr chunks),
//   - encodes sequence bytes through a 256-entry lookup table directly
//     into the caller-provided [cap, width] int8 base matrix (PAD-filled)
//     and quality bytes into Phred int8 (ASCII-33),
//   - decompresses .fastq.gz with zlib in multi-member streaming mode
//     (flate2 MultiGzDecoder semantics: keep inflating members until the
//     file ends; tolerate a truncated tail like input.rs:67-82).
//
// The interface is C (ctypes-friendly): an opaque reader handle yields
// batches of encoded reads. No Python object traffic on the hot path.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

#if defined(__AVX2__) && defined(__BMI2__)
#include <immintrin.h>
#define NGS_CODEC_AVX2 1
#endif

namespace {

constexpr int8_t kPad = 6;  // dna.PAD
constexpr int kOther = 5;   // dna.OTHER

struct LookupTables {
  int8_t base[256];
  int8_t phred[256];
  uint8_t two_bit[256];   // ACGT -> 0..3, everything else 0 (+exception)
  uint8_t is_exc[256];    // 1 where the 2-bit code loses information
  LookupTables() {
    for (int i = 0; i < 256; ++i) {
      base[i] = kOther;
      two_bit[i] = 0;
      is_exc[i] = 1;
      int q = i - 33;
      phred[i] = static_cast<int8_t>(q < 0 ? 0 : (q > 93 ? 93 : q));
    }
    // Uppercase only, matching dna.ASCII_TO_CODE: the reference compares
    // reads as-is, so lowercase bases never match and encode as OTHER.
    const char* bases = "ACGTN";
    for (int i = 0; i < 5; ++i) {
      base[static_cast<unsigned char>(bases[i])] = static_cast<int8_t>(i);
    }
    for (int i = 0; i < 4; ++i) {
      two_bit[static_cast<unsigned char>(bases[i])] = static_cast<uint8_t>(i);
      is_exc[static_cast<unsigned char>(bases[i])] = 0;
    }
  }
};
const LookupTables kTables;

// ---- SIMD sequence encoding -------------------------------------------
//
// The per-read hot loop is byte->2-bit packing plus exception detection.
// ACGT's ASCII codes admit a branch-free 2-bit encode: g = (ch >> 1) & 3
// maps A->0 C->1 G->3 T->2, and code = g ^ (g >> 1) swaps the last two
// into the wire convention A=0 C=1 G=2 T=3 (dna.ASCII_TO_CODE).  With
// AVX2 that is three vector ops over 32 bases, validity is four byte
// compares, and the 2-bit lanes compress to bytes with BMI2 pext —
// ~2.5x the scalar table loop per core (measured; see BENCH.md ingest).
// Scalar fallback keeps non-x86 builds correct.

#ifdef NGS_CODEC_AVX2
inline uint32_t valid_mask32(__m256i ch) {
  const __m256i vA = _mm256_set1_epi8('A');
  const __m256i vC = _mm256_set1_epi8('C');
  const __m256i vG = _mm256_set1_epi8('G');
  const __m256i vT = _mm256_set1_epi8('T');
  __m256i valid = _mm256_or_si256(
      _mm256_or_si256(_mm256_cmpeq_epi8(ch, vA), _mm256_cmpeq_epi8(ch, vC)),
      _mm256_or_si256(_mm256_cmpeq_epi8(ch, vG), _mm256_cmpeq_epi8(ch, vT)));
  return static_cast<uint32_t>(_mm256_movemask_epi8(valid));
}
#endif

// Number of information-losing bytes (everything outside uppercase ACGT).
inline size_t count_exceptions(const uint8_t* s, size_t n) {
  size_t exc = 0;
  size_t i = 0;
#ifdef NGS_CODEC_AVX2
  for (; i + 32 <= n; i += 32) {
    __m256i ch =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(s + i));
    exc += static_cast<size_t>(_mm_popcnt_u32(~valid_mask32(ch)));
  }
#endif
  for (; i < n; ++i) exc += kTables.is_exc[s[i]];
  return exc;
}

// Encode s[0..n) into 2-bit lanes of prow (pre-zeroed, stride bytes) and
// append (row_base + i, true_code) exception pairs in position order.
inline void pack_seq(const uint8_t* s, size_t n, uint8_t* prow,
                     int64_t row_base, int32_t* exc_idx, int8_t* exc_val,
                     int64_t& ne) {
  size_t i = 0;
#ifdef NGS_CODEC_AVX2
  alignas(32) uint8_t codes[32];
  const __m256i m06 = _mm256_set1_epi8(0x06);
  const __m256i m02 = _mm256_set1_epi8(0x02);
  for (; i + 32 <= n; i += 32) {
    __m256i ch =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(s + i));
    const __m256i vA = _mm256_set1_epi8('A');
    const __m256i vC = _mm256_set1_epi8('C');
    const __m256i vG = _mm256_set1_epi8('G');
    const __m256i vT = _mm256_set1_epi8('T');
    __m256i valid = _mm256_or_si256(
        _mm256_or_si256(_mm256_cmpeq_epi8(ch, vA),
                        _mm256_cmpeq_epi8(ch, vC)),
        _mm256_or_si256(_mm256_cmpeq_epi8(ch, vG),
                        _mm256_cmpeq_epi8(ch, vT)));
    uint32_t vm = static_cast<uint32_t>(_mm256_movemask_epi8(valid));
    __m256i g = _mm256_srli_epi16(_mm256_and_si256(ch, m06), 1);
    __m256i sw = _mm256_srli_epi16(_mm256_and_si256(g, m02), 1);
    __m256i code = _mm256_xor_si256(g, sw);
    // exceptions pack as 0 on the wire (the true code ships in exc_val)
    code = _mm256_and_si256(code, valid);
    _mm256_store_si256(reinterpret_cast<__m256i*>(codes), code);
    uint8_t* dst = prow + (i >> 2);
    for (int k = 0; k < 4; ++k) {
      uint64_t v;
      memcpy(&v, codes + 8 * k, 8);
      uint16_t p = static_cast<uint16_t>(
          _pext_u64(v, 0x0303030303030303ull));
      memcpy(dst + 2 * k, &p, 2);
    }
    if (vm != 0xFFFFFFFFu) {
      uint32_t bad = ~vm;
      while (bad) {
        int b = __builtin_ctz(bad);
        bad &= bad - 1;
        exc_idx[ne] = static_cast<int32_t>(row_base + i + b);
        exc_val[ne] = kTables.base[s[i + b]];
        ++ne;
      }
    }
  }
#endif
  for (; i < n; ++i) {
    uint8_t ch = s[i];
    prow[i >> 2] |= kTables.two_bit[ch] << ((i & 3) << 1);
    if (kTables.is_exc[ch]) {
      exc_idx[ne] = static_cast<int32_t>(row_base + i);
      exc_val[ne] = kTables.base[ch];
      ++ne;
    }
  }
}

// int8 base codes for the unpacked path (dna.ASCII_TO_CODE): ACGT ->
// 0..3 via the same branch-free encode, N -> 4, everything else -> 5.
inline void encode_bases(const uint8_t* s, size_t n, int8_t* out) {
  size_t i = 0;
#ifdef NGS_CODEC_AVX2
  const __m256i m06 = _mm256_set1_epi8(0x06);
  const __m256i m02 = _mm256_set1_epi8(0x02);
  const __m256i four = _mm256_set1_epi8(4);
  const __m256i five = _mm256_set1_epi8(5);
  for (; i + 32 <= n; i += 32) {
    __m256i ch =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(s + i));
    const __m256i vA = _mm256_set1_epi8('A');
    const __m256i vC = _mm256_set1_epi8('C');
    const __m256i vG = _mm256_set1_epi8('G');
    const __m256i vT = _mm256_set1_epi8('T');
    __m256i valid = _mm256_or_si256(
        _mm256_or_si256(_mm256_cmpeq_epi8(ch, vA),
                        _mm256_cmpeq_epi8(ch, vC)),
        _mm256_or_si256(_mm256_cmpeq_epi8(ch, vG),
                        _mm256_cmpeq_epi8(ch, vT)));
    __m256i g = _mm256_srli_epi16(_mm256_and_si256(ch, m06), 1);
    __m256i sw = _mm256_srli_epi16(_mm256_and_si256(g, m02), 1);
    __m256i code = _mm256_xor_si256(g, sw);
    __m256i isn = _mm256_cmpeq_epi8(ch, _mm256_set1_epi8('N'));
    __m256i other = _mm256_blendv_epi8(five, four, isn);
    code = _mm256_blendv_epi8(other, code, valid);
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i), code);
  }
#endif
  for (; i < n; ++i) out[i] = kTables.base[s[i]];
}

// Phred = clamp(ascii - 33, 0, 93), vectorized (saturating sub + min).
inline void encode_phred(const uint8_t* q, size_t n, int8_t* out) {
  size_t i = 0;
#ifdef NGS_CODEC_AVX2
  const __m256i off = _mm256_set1_epi8(33);
  const __m256i cap = _mm256_set1_epi8(93);
  for (; i + 32 <= n; i += 32) {
    __m256i v =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(q + i));
    v = _mm256_min_epu8(_mm256_subs_epu8(v, off), cap);
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i), v);
  }
#endif
  for (; i < n; ++i) out[i] = kTables.phred[q[i]];
}

struct Reader {
  FILE* f = nullptr;
  bool gz = false;
  z_stream zs{};
  bool z_live = false;
  bool eof = false;
  std::vector<uint8_t> inbuf;   // compressed input
  size_t in_pos = 0, in_len = 0;
  std::vector<uint8_t> buf;     // decoded text buffer
  size_t buf_pos = 0, buf_len = 0;
  // carry: partial line + line phase within the 4-line record
  std::vector<uint8_t> carry;   // bytes of the current incomplete line
  int phase = 0;                // 0=desc 1=seq 2=plus 3=qual
  std::vector<uint8_t> seq_line;
  // a fully-parsed record too wide for the caller's buffer, held until
  // the caller re-calls with a larger width
  std::vector<uint8_t> pend_qual;
  bool pending = false;
  uint64_t total_reads = 0;
  // byte-range reading (multi-host sharding, plain files only): a host
  // owns records whose description line starts in [range_start, range_end)
  uint64_t byte_off = 0;        // file offset of the next unconsumed byte
  uint64_t line_start_off = 0;  // file offset where the current line began
  uint64_t range_end = ~0ull;
  std::string error;
};

// Refill buf with decoded bytes. Returns false at end of data.
bool refill(Reader* r) {
  if (r->eof) return false;
  if (!r->gz) {
    r->buf_len = fread(r->buf.data(), 1, r->buf.size(), r->f);
    r->buf_pos = 0;
    if (r->buf_len == 0) r->eof = true;
    return r->buf_len > 0;
  }
  // gzip: inflate into buf, restarting members as needed
  r->buf_pos = 0;
  r->buf_len = 0;
  while (r->buf_len == 0) {
    if (r->in_pos == r->in_len) {
      r->in_len = fread(r->inbuf.data(), 1, r->inbuf.size(), r->f);
      r->in_pos = 0;
      if (r->in_len == 0) {  // file exhausted (maybe truncated member)
        r->eof = true;
        return false;
      }
    }
    if (!r->z_live) {
      memset(&r->zs, 0, sizeof(r->zs));
      if (inflateInit2(&r->zs, 31) != Z_OK) {
        r->error = "inflateInit2 failed";
        r->eof = true;
        return false;
      }
      r->z_live = true;
    }
    r->zs.next_in = r->inbuf.data() + r->in_pos;
    r->zs.avail_in = static_cast<uInt>(r->in_len - r->in_pos);
    r->zs.next_out = r->buf.data();
    r->zs.avail_out = static_cast<uInt>(r->buf.size());
    int rc = inflate(&r->zs, Z_NO_FLUSH);
    r->in_pos = r->in_len - r->zs.avail_in;
    r->buf_len = r->buf.size() - r->zs.avail_out;
    if (rc == Z_STREAM_END) {
      inflateEnd(&r->zs);
      r->z_live = false;  // next member (multi-member gz)
    } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
      // corrupt/truncated stream: surface what we have, stop like the
      // reference's read-0 exit (input.rs:67-82)
      r->eof = true;
      return r->buf_len > 0;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Open a reader. gz != 0 for .fastq.gz. Returns null on failure.
void* fastq_open(const char* path, int gz, size_t chunk_bytes) {
  Reader* r = new Reader();
  r->f = fopen(path, "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  r->gz = gz != 0;
  r->buf.resize(chunk_bytes);
  if (r->gz) r->inbuf.resize(chunk_bytes);
  r->carry.reserve(1024);
  r->seq_line.reserve(1024);
  return r;
}

// Open an in-memory FASTQ buffer (used by the BGZF-parallel reader:
// each thread inflates its block span to memory and parses here).
// `range_end` bounds record ownership exactly like fastq_open_range;
// the buffer must outlive the reader (the bytes are copied in, so it
// need not).
void* fastq_open_mem(const uint8_t* data, uint64_t len, uint64_t range_end) {
  Reader* r = new Reader();
  r->gz = false;
  r->buf.assign(data, data + len);
  r->buf_len = len;
  r->buf_pos = 0;
  r->eof = true;  // refill() will find nothing more
  r->range_end = range_end;
  r->carry.reserve(1024);
  r->seq_line.reserve(1024);
  return r;
}

// Open a byte range of a PLAIN fastq (multi-host sharding).  `start`
// must already be aligned to a record boundary (the Python wrapper
// aligns it); records whose description line starts at or beyond `end`
// belong to the next host and are not emitted.
void* fastq_open_range(const char* path, size_t chunk_bytes,
                       uint64_t start, uint64_t end) {
  Reader* r = static_cast<Reader*>(fastq_open(path, 0, chunk_bytes));
  if (!r) return nullptr;
  if (start && fseeko(r->f, static_cast<off_t>(start), SEEK_SET) != 0) {
    fclose(r->f);
    delete r;
    return nullptr;
  }
  r->byte_off = start;
  r->line_start_off = start;
  r->range_end = end;
  return r;
}

void fastq_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  if (r->z_live) inflateEnd(&r->zs);
  if (r->f) fclose(r->f);
  delete r;
}

uint64_t fastq_total_reads(void* h) {
  return static_cast<Reader*>(h)->total_reads;
}

// Byte offset of the next unconsumed record (valid at batch boundaries
// when no record is held pending; plain files only).  Used for
// checkpoint/resume: reopen with fastq_open_range(path, ..., tell, ~0).
uint64_t fastq_tell(void* h) {
  Reader* r = static_cast<Reader*>(h);
  return r->byte_off;
}

int fastq_has_pending(void* h) {
  Reader* r = static_cast<Reader*>(h);
  return (r->pending || !r->carry.empty() || r->phase != 0) ? 1 : 0;
}

namespace {

// Emit one parsed (seq_line, qual) record into row n.
void emit_row(Reader* r, const uint8_t* qual, size_t qlen, int64_t n,
              int64_t width, int8_t* bases, int8_t* quals,
              int32_t* lengths) {
  int8_t* brow = bases + n * width;
  int8_t* qrow = quals + n * width;
  size_t sl = r->seq_line.size();
  encode_bases(r->seq_line.data(), sl, brow);
  size_t ql = qlen < sl ? qlen : sl;
  encode_phred(qual, ql, qrow);
  if (ql < sl) memset(qrow + ql, 0, sl - ql);
  memset(brow + sl, kPad, width - sl);
  memset(qrow + sl, 0, width - sl);
  lengths[n] = static_cast<int32_t>(sl);
  ++r->total_reads;
}

}  // namespace

// Fill up to `cap` reads into bases[cap*width], quals[cap*width] (both
// pre-sized by the caller), lengths[cap].  Rows are PAD/0-filled for the
// used rows.  Returns the number of reads written; 0 means end of file;
// a NEGATIVE value -w means a read of length w exceeded `width`: the
// caller must retry with width >= w (no data is lost — the record is
// held inside the reader).
int64_t fastq_next_batch(void* h, int64_t cap, int64_t width,
                         int8_t* bases, int8_t* quals, int32_t* lengths) {
  Reader* r = static_cast<Reader*>(h);
  int64_t n = 0;
  if (r->pending) {
    int64_t need = static_cast<int64_t>(r->seq_line.size());
    if (need > width) return -need;
    emit_row(r, r->pend_qual.data(), r->pend_qual.size(), n, width, bases,
             quals, lengths);
    ++n;
    r->pending = false;
    r->phase = 0;
  }
  while (n < cap) {
    if (r->buf_pos >= r->buf_len) {
      if (!refill(r)) break;
    }
    const uint8_t* p = r->buf.data() + r->buf_pos;
    size_t avail = r->buf_len - r->buf_pos;
    const uint8_t* nl =
        static_cast<const uint8_t*>(memchr(p, '\n', avail));
    size_t line_len = nl ? static_cast<size_t>(nl - p) : avail;

    if (r->carry.empty()) r->line_start_off = r->byte_off;
    r->byte_off += line_len + (nl ? 1 : 0);

    const uint8_t* line = p;
    size_t full_len = line_len;
    if (!r->carry.empty() || !nl) {
      // accumulate into carry until the newline arrives
      r->carry.insert(r->carry.end(), p, p + line_len);
      r->buf_pos += line_len + (nl ? 1 : 0);
      if (!nl) continue;  // need more data
      line = r->carry.data();
      full_len = r->carry.size();
    } else {
      r->buf_pos += line_len + 1;
    }
    // strip \r
    if (full_len && line[full_len - 1] == '\r') --full_len;

    switch (r->phase) {
      case 0:  // description
        if (r->line_start_off >= r->range_end) {  // next host's record
          r->eof = true;
          return n;
        }
        r->phase = 1;
        break;
      case 1:  // sequence: stash until quality arrives
        r->seq_line.assign(line, line + full_len);
        r->phase = 2;
        break;
      case 2:  // plus
        r->phase = 3;
        break;
      case 3: {  // quality: emit the record
        if (r->seq_line.size() > static_cast<size_t>(width)) {
          // too wide for the caller's buffer: hold and signal
          r->pend_qual.assign(line, line + full_len);
          r->pending = true;
          r->carry.clear();
          return n > 0 ? n : -static_cast<int64_t>(r->seq_line.size());
        }
        emit_row(r, line, full_len, n, width, bases, quals, lengths);
        ++n;
        r->phase = 0;
        break;
      }
    }
    r->carry.clear();
  }
  return n;
}

// Packed variant for minimal host->device traffic: 2 bits per base
// (A=0 C=1 G=2 T=3) into `packed[cap * width/4]`, with information-losing
// characters (N, rare IUPAC, etc.) emitted as (flat_index, true_code)
// exception pairs the device scatters after unpacking.  `quals` may be
// null when the quality gate is off (no Phred bytes cross the link).
//
// Returns: n > 0 reads; 0 EOF; -w (w > 1) a read needs width >= w;
// -1 exception capacity exhausted — *exc_count holds the minimum needed
// capacity; the in-flight record is held pending, nothing is lost.
int64_t fastq_next_batch_packed(void* h, int64_t cap, int64_t width,
                                uint8_t* packed, int32_t* lengths,
                                int64_t cap_exc, int32_t* exc_idx,
                                int8_t* exc_val, int64_t* exc_count,
                                int8_t* quals) {
  Reader* r = static_cast<Reader*>(h);
  const int64_t stride = width / 4;
  int64_t n = 0;
  int64_t ne = 0;

  auto emit_packed = [&](const uint8_t* qual, size_t qlen) -> int {
    size_t sl = r->seq_line.size();
    // count exceptions first so overflow can hold the whole record
    size_t exc_here = count_exceptions(r->seq_line.data(), sl);
    if (static_cast<int64_t>(ne + exc_here) > cap_exc) {
      *exc_count = -static_cast<int64_t>(ne + exc_here);
      return -1;
    }
    uint8_t* prow = packed + n * stride;
    memset(prow, 0, stride);
    pack_seq(r->seq_line.data(), sl, prow, n * width, exc_idx, exc_val, ne);
    if (quals) {
      int8_t* qrow = quals + n * width;
      size_t ql = qlen < sl ? qlen : sl;
      encode_phred(qual, ql, qrow);
      memset(qrow + ql, 0, width - ql);
    }
    lengths[n] = static_cast<int32_t>(sl);
    ++r->total_reads;
    return 0;
  };

  if (r->pending) {
    int64_t need = static_cast<int64_t>(r->seq_line.size());
    if (need > width) return -need;
    if (emit_packed(r->pend_qual.data(), r->pend_qual.size()) != 0) return -1;
    ++n;
    r->pending = false;
    r->phase = 0;
  }
  while (n < cap) {
    if (r->buf_pos >= r->buf_len) {
      if (!refill(r)) break;
    }
    const uint8_t* p = r->buf.data() + r->buf_pos;
    size_t avail = r->buf_len - r->buf_pos;
    const uint8_t* nl = static_cast<const uint8_t*>(memchr(p, '\n', avail));
    size_t line_len = nl ? static_cast<size_t>(nl - p) : avail;

    if (r->carry.empty()) r->line_start_off = r->byte_off;
    r->byte_off += line_len + (nl ? 1 : 0);

    const uint8_t* line = p;
    size_t full_len = line_len;
    if (!r->carry.empty() || !nl) {
      r->carry.insert(r->carry.end(), p, p + line_len);
      r->buf_pos += line_len + (nl ? 1 : 0);
      if (!nl) continue;
      line = r->carry.data();
      full_len = r->carry.size();
    } else {
      r->buf_pos += line_len + 1;
    }
    if (full_len && line[full_len - 1] == '\r') --full_len;

    switch (r->phase) {
      case 0:
        if (r->line_start_off >= r->range_end) {
          r->eof = true;
          *exc_count = ne;
          return n;
        }
        r->phase = 1;
        break;
      case 1:
        r->seq_line.assign(line, line + full_len);
        r->phase = 2;
        break;
      case 2:
        r->phase = 3;
        break;
      case 3: {
        if (r->seq_line.size() > static_cast<size_t>(width)) {
          r->pend_qual.assign(line, line + full_len);
          r->pending = true;
          r->carry.clear();
          *exc_count = ne;
          return n > 0 ? n : -static_cast<int64_t>(r->seq_line.size());
        }
        if (emit_packed(line, full_len) != 0) {
          r->pend_qual.assign(line, line + full_len);
          r->pending = true;
          r->carry.clear();
          if (n > 0) {  // emit what we have; pending resumes next call
            // exc_count currently holds -(needed); restore count for this
            // batch and let the next call grow if still needed
            *exc_count = ne;
            return n;
          }
          return -1;  // *exc_count = -(needed)
        }
        ++n;
        r->phase = 0;
        break;
      }
    }
    r->carry.clear();
  }
  *exc_count = ne;
  return n;
}

// Stable LSD radix argsort of u64 keys (8 passes x 8-bit digits).
// The wire-sort producer stage clusters similar reads before the
// col-major transpose (parallel_ingest._sort_batch_rows); numpy's
// comparison argsort took 12ms per 131k-read batch — this runs ~1.5ms,
// freeing producer-thread CPU a slow link's compressor competes for.
void radix_argsort_u64(const uint64_t* keys, int64_t n, int32_t* order) {
  std::vector<int32_t> tmp(static_cast<size_t>(n));
  int32_t* src = order;
  int32_t* dst = tmp.data();
  for (int64_t i = 0; i < n; ++i) order[i] = static_cast<int32_t>(i);
  // one read of the key array builds all 8 digit histograms (8-bit
  // digits keep every histogram L1-resident); constant digits skip
  int64_t hist[8][256] = {};
  for (int64_t i = 0; i < n; ++i) {
    uint64_t k = keys[i];
    for (int p = 0; p < 8; ++p) ++hist[p][(k >> (p * 8)) & 0xFF];
  }
  for (int pass = 0; pass < 8; ++pass) {
    int64_t* h = hist[pass];
    uint64_t first = n ? (keys[src[0]] >> (pass * 8)) & 0xFF : 0;
    if (h[first] == n) continue;  // constant digit: stable no-op
    int64_t sum = 0;
    for (int b = 0; b < 256; ++b) {
      int64_t c = h[b];
      h[b] = sum;
      sum += c;
    }
    const int shift = pass * 8;
    for (int64_t i = 0; i < n; ++i) {
      int32_t s = src[i];
      dst[h[(keys[s] >> shift) & 0xFF]++] = s;
    }
    int32_t* t = src;
    src = dst;
    dst = t;
  }
  if (src != order) memcpy(order, src, static_cast<size_t>(n) * 4);
}

// Inflate all gzip members whose first byte lies in file range
// [start, end) into `out` (the BGZF-parallel reader: ISIZE fields give
// the caller the exact output size up front).  Returns bytes written or
// -1 on error.  Pure C path — ctypes releases the GIL, so threads
// decompress truly in parallel (Python-side zlib.decompress on 64KB
// members serializes on interpreter overhead).
int64_t gz_inflate_span(const char* path, uint64_t start, uint64_t end,
                        uint8_t* out, uint64_t out_cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseeko(f, static_cast<off_t>(start), SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  std::vector<uint8_t> in(1 << 20);
  uint64_t remaining = end - start;
  uint64_t written = 0;
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  bool live = false;
  bool ok = true;
  size_t in_len = 0, in_pos = 0;
  while (ok) {
    if (in_pos == in_len) {
      if (remaining == 0) break;
      size_t want = remaining < in.size() ? remaining : in.size();
      in_len = fread(in.data(), 1, want, f);
      in_pos = 0;
      remaining -= in_len;
      if (in_len == 0) break;  // truncated file: stop with what we have
    }
    if (!live) {
      memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, 31) != Z_OK) { ok = false; break; }
      live = true;
    }
    if (written >= out_cap) { ok = false; break; }  // ISIZE lied
    zs.next_in = in.data() + in_pos;
    zs.avail_in = static_cast<uInt>(in_len - in_pos);
    zs.next_out = out + written;
    uint64_t room = out_cap - written;
    zs.avail_out = static_cast<uInt>(room > 0xFFFFFFFFull ? 0xFFFFFFFFull
                                                          : room);
    int rc = inflate(&zs, Z_NO_FLUSH);
    in_pos = in_len - zs.avail_in;
    written = static_cast<uint64_t>(zs.next_out - out);
    if (rc == Z_STREAM_END) {
      inflateEnd(&zs);
      live = false;
    } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
      ok = false;
    }
  }
  if (live) inflateEnd(&zs);
  fclose(f);
  return ok ? static_cast<int64_t>(written) : -1;
}

// Quick pre-scan helper: decode up to `limit` bytes and report the max
// sequence-line length seen (for width bucketing) plus first-line info.
// Returns max length, or -1 on error.  Also writes the first two lines'
// "looks like DNA" flags for the format check (parse.rs:377-427).
int64_t fastq_scan_max_len(const char* path, int gz, size_t limit,
                           int* first_is_dna, int* second_is_dna) {
  Reader* r = static_cast<Reader*>(fastq_open(path, gz, 1 << 20));
  if (!r) return -1;
  int64_t maxlen = 0;
  size_t seen = 0;
  int phase = 0;
  int lineno = 0;
  std::vector<uint8_t> carry;
  bool done = false;
  while (!done && seen < limit) {
    if (r->buf_pos >= r->buf_len) {
      if (!refill(r)) break;
    }
    const uint8_t* p = r->buf.data() + r->buf_pos;
    size_t avail = r->buf_len - r->buf_pos;
    const uint8_t* nl = static_cast<const uint8_t*>(memchr(p, '\n', avail));
    size_t line_len = nl ? static_cast<size_t>(nl - p) : avail;
    carry.insert(carry.end(), p, p + line_len);
    r->buf_pos += line_len + (nl ? 1 : 0);
    seen += line_len + 1;
    if (!nl) continue;
    size_t full = carry.size();
    if (full && carry[full - 1] == '\r') --full;
    if (lineno < 2) {
      size_t dna = 0;
      for (size_t i = 0; i < full; ++i) {
        uint8_t c = carry[i];
        if (c == 'A' || c == 'C' || c == 'G' || c == 'T' || c == 'N') ++dna;
      }
      int is_dna = !(dna < full / 2);
      if (lineno == 0) *first_is_dna = is_dna;
      if (lineno == 1) *second_is_dna = is_dna;
    }
    if (phase == 1 && static_cast<int64_t>(full) > maxlen)
      maxlen = static_cast<int64_t>(full);
    phase = (phase + 1) % 4;
    ++lineno;
    carry.clear();
  }
  fastq_close(r);
  return maxlen;
}

}  // extern "C"
