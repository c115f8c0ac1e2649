// fslr-tpu native host runtime: FASTQ/FASTA parsing at IO speed.
//
// The reference pipeline's IO edge is native (pysam/htslib readers, gzip;
// SURVEY.md N8/N9).  This library is the equivalent for this engine:
// it parses FASTQ/FASTA (plain or gzip, via zlib's gzFile which handles
// multi-member streams) in one pass and emits
//   * 2-bit+N encoded sequence codes (A=0 C=1 G=2 T=3 other=4) into a
//     caller-provided buffer,
//   * a lowercase mask bit per base (tantan-style masking survives
//     round-trips),
//   * record offsets, name/quality byte ranges,
// so Python receives ready-to-batch numpy arrays with no per-read string
// work.  Exposed through ctypes (no pybind11 in this image).
//
// Build: make -C native   (g++ -O3 -shared -fPIC, links -lz)

#include <zlib.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Parsed {
  std::vector<uint8_t> codes;      // concatenated encoded bases
  std::vector<uint8_t> lower;      // 1 = base was lowercase
  std::vector<int64_t> seq_off;    // n+1 offsets into codes
  std::string names;               // concatenated name bytes
  std::vector<int64_t> name_off;   // n+1 offsets into names
  std::string quals;               // concatenated quality bytes ('' if none)
  std::vector<int64_t> qual_off;   // n+1 offsets into quals
  std::string comments;            // concatenated comment bytes
  std::vector<int64_t> comment_off;
};

uint8_t g_enc[256];
uint8_t g_low[256];

struct InitTables {
  InitTables() {
    memset(g_enc, 4, sizeof(g_enc));
    g_enc[(int)'A'] = 0; g_enc[(int)'C'] = 1;
    g_enc[(int)'G'] = 2; g_enc[(int)'T'] = 3;
    g_enc[(int)'a'] = 0; g_enc[(int)'c'] = 1;
    g_enc[(int)'g'] = 2; g_enc[(int)'t'] = 3;
    memset(g_low, 0, sizeof(g_low));
    for (int c = 'a'; c <= 'z'; ++c) g_low[c] = 1;
  }
} g_init;

bool read_all(const char* path, std::string* out) {
  FILE* plain = fopen(path, "rb");
  if (!plain) return false;
  unsigned char magic[2] = {0, 0};
  size_t got = fread(magic, 1, 2, plain);
  if (!(got == 2 && magic[0] == 0x1f && magic[1] == 0x8b)) {
    // plain file: chunked fread (sandboxed kernels make huge single
    // reads pathologically slow; 1 MB chunks match page-cache behavior)
    fseek(plain, 0, SEEK_END);
    long size = ftell(plain);
    fseek(plain, 0, SEEK_SET);
    if (size > 0) out->reserve(size);
    std::vector<char> buf(1 << 20);
    size_t rd;
    while ((rd = fread(buf.data(), 1, buf.size(), plain)) > 0)
      out->append(buf.data(), rd);
    fclose(plain);
    return true;
  }
  fclose(plain);
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  gzbuffer(f, 1 << 22);
  std::vector<char> buf(1 << 22);
  int n;
  while ((n = gzread(f, buf.data(), buf.size())) > 0) out->append(buf.data(), n);
  gzclose(f);
  return n >= 0;
}

// Split the header line after '>'/'@' into name (to first space/tab) and
// comment (the rest), matching the Python reader.
void push_header(Parsed* p, const char* s, const char* e) {
  const char* sep = s;
  while (sep < e && *sep != ' ' && *sep != '\t') ++sep;
  p->names.append(s, sep - s);
  p->name_off.push_back((int64_t)p->names.size());
  if (sep < e) {
    p->comments.append(sep + 1, e - sep - 1);
  }
  p->comment_off.push_back((int64_t)p->comments.size());
}

void push_seq(Parsed* p, const char* s, const char* e) {
  size_t off = p->codes.size();
  size_t n = e - s;
  p->codes.resize(off + n);
  p->lower.resize(off + n);
  uint8_t* cd = p->codes.data() + off;
  uint8_t* lo = p->lower.data() + off;
  for (size_t i = 0; i < n; ++i) {
    uint8_t c = (uint8_t)s[i];
    cd[i] = g_enc[c];
    lo[i] = g_low[c];
  }
}

Parsed* parse(const std::string& data) {
  Parsed* p = new Parsed();
  p->seq_off.push_back(0);
  p->name_off.push_back(0);
  p->qual_off.push_back(0);
  p->comment_off.push_back(0);
  const char* cur = data.data();
  const char* end = cur + data.size();
  auto line_end = [&](const char* s) {
    const char* nl = (const char*)memchr(s, '\n', end - s);
    return nl ? nl : end;
  };
  if (cur >= end) return p;
  bool fastq = *cur == '@';
  while (cur < end) {
    if (*cur != (fastq ? '@' : '>')) break;  // malformed; stop cleanly
    const char* he = line_end(cur);
    const char* hs = cur + 1;
    const char* hee = he;
    if (hee > hs && hee[-1] == '\r') --hee;
    push_header(p, hs, hee);
    cur = he < end ? he + 1 : end;
    if (fastq) {
      const char* se = line_end(cur);
      const char* see = se;
      if (see > cur && see[-1] == '\r') --see;
      push_seq(p, cur, see);
      p->seq_off.push_back((int64_t)p->codes.size());
      cur = se < end ? se + 1 : end;
      cur = line_end(cur);                   // '+' line
      cur = cur < end ? cur + 1 : end;
      const char* qe = line_end(cur);
      const char* qee = qe;
      if (qee > cur && qee[-1] == '\r') --qee;
      p->quals.append(cur, qee - cur);
      p->qual_off.push_back((int64_t)p->quals.size());
      cur = qe < end ? qe + 1 : end;
    } else {
      while (cur < end && *cur != '>') {
        const char* se = line_end(cur);
        const char* see = se;
        if (see > cur && see[-1] == '\r') --see;
        push_seq(p, cur, see);
        cur = se < end ? se + 1 : end;
      }
      p->seq_off.push_back((int64_t)p->codes.size());
      p->qual_off.push_back((int64_t)p->quals.size());
    }
  }
  return p;
}

}  // namespace

// Run-length decode of traceback emit streams (ops/traceback.py): rows of
// 2-bit codes packed 4/byte (0/1/2 = M/I/D, 3 = none), emitted end->start
// so each row is scanned byte-reversed, high shift first.  The numpy
// decode materializes an index pair per emitted base (~16 bytes/base);
// this is a plain byte scan.
struct Emits {
  std::vector<int32_t> off;   // n+1 segment offsets
  std::vector<int32_t> len;   // segment lengths
  std::vector<uint8_t> op;    // segment op codes (0/1/2)
};

extern "C" {

void* fslr_decode_emits(const uint8_t* blocks, int64_t n, int64_t t4) {
  Emits* E = new Emits();
  E->off.resize(n + 1);
  E->off[0] = 0;
  E->len.reserve((size_t)n * 8);
  E->op.reserve((size_t)n * 8);
  for (int64_t r = 0; r < n; ++r) {
    const uint8_t* row = blocks + r * t4;
    int cur = -1;
    int32_t run = 0;
    for (int64_t b = t4 - 1; b >= 0; --b) {
      uint8_t by = row[b];
      if (by == 0xff) continue;          // 4x "none": padding fast path
      for (int sh = 6; sh >= 0; sh -= 2) {
        int c = (by >> sh) & 3;
        if (c == 3) continue;
        if (c == cur) {
          ++run;
        } else {
          if (cur >= 0) {
            E->len.push_back(run);
            E->op.push_back((uint8_t)cur);
          }
          cur = c;
          run = 1;
        }
      }
    }
    if (cur >= 0) {
      E->len.push_back(run);
      E->op.push_back((uint8_t)cur);
    }
    E->off[r + 1] = (int32_t)E->len.size();
  }
  return E;
}

int64_t fslr_emits_total(void* h) {
  return (int64_t)((Emits*)h)->len.size();
}

void fslr_emits_copy(void* h, int32_t* off, int32_t* len, uint8_t* op) {
  Emits* E = (Emits*)h;
  memcpy(off, E->off.data(), E->off.size() * 4);
  memcpy(len, E->len.data(), E->len.size() * 4);
  memcpy(op, E->op.data(), E->op.size());
}

void fslr_emits_free(void* h) { delete (Emits*)h; }

// Parse a file; returns an opaque handle (or null).  Use the accessors to
// copy sizes/buffers out, then free.
void* fslr_fastx_parse(const char* path) {
  std::string data;
  if (!read_all(path, &data)) return nullptr;
  return parse(data);
}

int64_t fslr_fastx_n(void* h) {
  return (int64_t)((Parsed*)h)->seq_off.size() - 1;
}
int64_t fslr_fastx_codes_len(void* h) {
  return (int64_t)((Parsed*)h)->codes.size();
}
int64_t fslr_fastx_names_len(void* h) {
  return (int64_t)((Parsed*)h)->names.size();
}
int64_t fslr_fastx_quals_len(void* h) {
  return (int64_t)((Parsed*)h)->quals.size();
}
int64_t fslr_fastx_comments_len(void* h) {
  return (int64_t)((Parsed*)h)->comments.size();
}

void fslr_fastx_copy(void* h, uint8_t* codes, uint8_t* lower,
                     int64_t* seq_off, char* names, int64_t* name_off,
                     char* quals, int64_t* qual_off, char* comments,
                     int64_t* comment_off) {
  Parsed* p = (Parsed*)h;
  memcpy(codes, p->codes.data(), p->codes.size());
  memcpy(lower, p->lower.data(), p->lower.size());
  memcpy(seq_off, p->seq_off.data(), p->seq_off.size() * 8);
  memcpy(names, p->names.data(), p->names.size());
  memcpy(name_off, p->name_off.data(), p->name_off.size() * 8);
  memcpy(quals, p->quals.data(), p->quals.size());
  memcpy(qual_off, p->qual_off.data(), p->qual_off.size() * 8);
  memcpy(comments, p->comments.data(), p->comments.size());
  memcpy(comment_off, p->comment_off.data(), p->comment_off.size() * 8);
}

void fslr_fastx_free(void* h) { delete (Parsed*)h; }

}  // extern "C"
