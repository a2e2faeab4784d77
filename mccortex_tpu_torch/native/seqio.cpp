// Native sequence ingest: FASTA/FASTQ/SAM/BAM (plain or gzip/BGZF) ->
// base codes, the host-side decode path of `build` and of `thread`.
// Copy of mccortex_tpu/native/seqio.cpp with two changes: the FASTQ
// quality offset and the chunk overlap are arguments of mctx_seq_open,
// held per handle, instead of process-wide settings, so that two
// readers open at once (the two mates of a pair, each on its own
// prefetch thread) keep their own; and a second entry point,
// mctx_seq_read_records, hands out whole records by the rules of the
// Python reader (io/seqio.parse_reads).  Both entry points share one
// record parser, next_record.  Exposed as a small C ABI consumed via
// ctypes (mccortex_tpu_torch/native/__init__.py).
//
// BAM's BGZF container is a sequence of concatenated gzip members,
// which zlib's gzread traverses transparently; no htslib is needed for
// read-only sequence access.  Secondary (0x100) and supplementary
// (0x800) alignments are skipped so reads are not double-counted.
//
// Base coding matches mccortex_tpu_torch.constants: A=0 C=1 G=2 T=3,
// other=4.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <zlib.h>

namespace {

struct SeqFile {
  gzFile gz;            // zlib handles plain files transparently
  int format;           // 0 unknown, 1 fasta, 2 fastq
  char *linebuf;
  size_t linecap;
  bool have_pending;    // a header line already read
  char *pending;
  size_t pendingcap;
  int fq_offset;        // 33/64; 0 = auto-detect from first record
  // chunk overlap: consecutive rows of a record longer than a row share
  // this many bases, so every kmer and every kmer->kmer edge survives
  // the split (overlap >= k); callers that know k pass it exactly for
  // one duplicate kmer observation per seam
  long overlap;
  // full-record scratch: sequences longer than a row are emitted as
  // overlapping chunks (never truncated)
  uint8_t *sc_codes;
  uint8_t *sc_quals;
  size_t sc_cap;
  size_t sc_len;        // record length in scratch
  size_t sc_off;        // next chunk start (sc_off < sc_len = pending)
  bool sc_has_quals;
  bool held;            // a whole record in scratch not yet handed out
};

uint8_t base_code[256];

struct CodeInit {
  CodeInit() {
    memset(base_code, 4, sizeof(base_code));
    base_code[(int)'A'] = base_code[(int)'a'] = 0;
    base_code[(int)'C'] = base_code[(int)'c'] = 1;
    base_code[(int)'G'] = base_code[(int)'g'] = 2;
    base_code[(int)'T'] = base_code[(int)'t'] = 3;
  }
} code_init;

// gz-aware getline; returns length or -1 on EOF. Strips trailing \n/\r.
long read_line(SeqFile *f, char **buf, size_t *cap) {
  size_t len = 0;
  for (;;) {
    if (len + 4096 > *cap) {
      *cap = (*cap ? *cap * 2 : 8192);
      *buf = (char *)realloc(*buf, *cap);
    }
    char *dst = *buf + len;
    if (gzgets(f->gz, dst, (int)(*cap - len)) == NULL) {
      if (len == 0) return -1;
      break;
    }
    size_t got = strlen(dst);
    len += got;
    if (len > 0 && (*buf)[len - 1] == '\n') break;
  }
  while (len > 0 && ((*buf)[len - 1] == '\n' || (*buf)[len - 1] == '\r'))
    len--;
  (*buf)[len] = '\0';
  return (long)len;
}

}  // namespace

extern "C" {

void mctx_seq_close(void *h);

// Open a sequence file.  fq_offset: FASTQ quality ASCII offset, 33 or
// 64, 0 = auto-detect from the first record.  overlap: bases shared by
// consecutive rows of a chunked record (<= 0: 64, enough for k <= 63).
void *mctx_seq_open(const char *path, int fq_offset, long overlap) {
  gzFile gz = gzopen(path, "rb");
  if (!gz) return nullptr;
  gzbuffer(gz, 1 << 20);
  SeqFile *f = new SeqFile();
  f->gz = gz;
  f->format = 0;
  f->linebuf = nullptr;
  f->linecap = 0;
  f->have_pending = false;
  f->pending = nullptr;
  f->pendingcap = 0;
  f->fq_offset = fq_offset;
  f->overlap = overlap > 0 ? overlap : 64;
  f->sc_codes = nullptr;
  f->sc_quals = nullptr;
  f->sc_cap = 0;
  f->sc_len = 0;
  f->sc_off = 0;
  f->sc_has_quals = false;
  f->held = false;
  // BAM detection: decompressed stream starts with "BAM\1"
  char magic[4];
  int got = gzread(gz, magic, 4);
  if (got == 4 && memcmp(magic, "BAM\1", 4) == 0) {
    f->format = 3;
    // header: l_text, text, n_ref, then per-ref (l_name, name, l_ref)
    int32_t l_text = 0, n_ref = 0;
    if (gzread(gz, &l_text, 4) != 4) { mctx_seq_close(f); return nullptr; }
    if (gzseek(gz, l_text, SEEK_CUR) < 0) { mctx_seq_close(f); return nullptr; }
    if (gzread(gz, &n_ref, 4) != 4) { mctx_seq_close(f); return nullptr; }
    for (int32_t r = 0; r < n_ref; r++) {
      int32_t l_name = 0;
      if (gzread(gz, &l_name, 4) != 4) { mctx_seq_close(f); return nullptr; }
      if (gzseek(gz, l_name + 4, SEEK_CUR) < 0) {
        mctx_seq_close(f); return nullptr;
      }
    }
  } else {
    gzrewind(gz);
  }
  return f;
}

namespace {

// 4-bit BAM seq codes "=ACMGRSVTWYHKDBN" -> base codes
const uint8_t bam4_code[16] = {4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4,
                               4, 4, 4, 4};

void sc_reserve(SeqFile *f, size_t need) {
  if (f->sc_cap < need) {
    f->sc_cap = need * 2;
    f->sc_codes = (uint8_t *)realloc(f->sc_codes, f->sc_cap);
    f->sc_quals = (uint8_t *)realloc(f->sc_quals, f->sc_cap);
  }
}

// Emit the next chunk of the scratch record into row n.  Rows longer
// than max_len continue in the next row with f->overlap shared
// bases, so no sequence is ever truncated (chromosome-length FASTA
// records, long reads).
void sc_emit(SeqFile *f, long max_len, uint8_t *crow, uint8_t *qrow,
             int32_t *len_out) {
  size_t off = f->sc_off;
  size_t take = f->sc_len - off;
  if ((long)take > max_len) take = (size_t)max_len;
  memcpy(crow, f->sc_codes + off, take);
  if (f->sc_has_quals) memcpy(qrow, f->sc_quals + off, take);
  *len_out = (int32_t)take;
  if (off + take >= f->sc_len) {
    f->sc_len = f->sc_off = 0;        // record fully emitted
  } else {
    long ov = f->overlap;
    size_t step = max_len > ov ? (size_t)(max_len - ov) : 0;
    f->sc_off = off + (step > 0 ? step : (size_t)max_len);
  }
}

// One BAM alignment record into the scratch.  Returns 1 on success,
// 0 at EOF, -1 on error, 2 if the record was skipped.
int read_bam_record(SeqFile *f) {
  int32_t block_size = 0;
  int got = gzread(f->gz, &block_size, 4);
  if (got == 0) return 0;
  if (got != 4 || block_size < 32) return -1;
  if (f->pendingcap < (size_t)block_size) {
    f->pendingcap = (size_t)block_size * 2;
    f->pending = (char *)realloc(f->pending, f->pendingcap);
  }
  if (gzread(f->gz, f->pending, block_size) != block_size) return -1;
  const uint8_t *p = (const uint8_t *)f->pending;
  uint8_t l_read_name = p[8];
  uint16_t n_cigar, flag;
  int32_t l_seq;
  memcpy(&n_cigar, p + 12, 2);
  memcpy(&flag, p + 14, 2);
  memcpy(&l_seq, p + 16, 4);
  if (flag & (0x100 | 0x800)) return 2;   // secondary/supplementary
  if (l_seq <= 0) return 2;
  size_t off = 32 + l_read_name + (size_t)n_cigar * 4;
  if (off + (l_seq + 1) / 2 + l_seq > (size_t)block_size) return -1;
  const uint8_t *seq4 = p + off;
  const uint8_t *qual = seq4 + (l_seq + 1) / 2;
  sc_reserve(f, (size_t)l_seq);
  for (int32_t i = 0; i < l_seq; i++) {
    uint8_t nib = (i & 1) ? (seq4[i / 2] & 0xF) : (seq4[i / 2] >> 4);
    f->sc_codes[i] = bam4_code[nib];
  }
  for (int32_t i = 0; i < l_seq; i++)
    f->sc_quals[i] = (qual[i] == 0xFF) ? 0 : qual[i];
  f->sc_len = (size_t)l_seq;
  f->sc_off = 0;
  f->sc_has_quals = true;
  return 1;
}

// One SAM record line (already split into fields) into the scratch.
// Returns 1 on success, 2 if skipped.
int parse_sam_line(SeqFile *f, char *line) {
  // fields: QNAME FLAG RNAME POS MAPQ CIGAR RNEXT PNEXT TLEN SEQ QUAL
  char *fields[12];
  int nf = 0;
  char *s = line;
  fields[nf++] = s;
  while (*s && nf < 12) {
    if (*s == '\t') { *s = '\0'; fields[nf++] = s + 1; }
    s++;
  }
  if (nf < 11) return 2;
  long flag = strtol(fields[1], nullptr, 10);
  if (flag & (0x100 | 0x800)) return 2;
  const char *seq = fields[9];
  const char *qual = fields[10];
  if (seq[0] == '*' && seq[1] == '\0') return 2;
  long l = (long)strlen(seq);
  sc_reserve(f, (size_t)l);
  for (long i = 0; i < l; i++)
    f->sc_codes[i] = base_code[(uint8_t)seq[i]];
  memset(f->sc_quals, 0, (size_t)l);
  f->sc_has_quals = false;
  if (!(qual[0] == '*' && qual[1] == '\0')) {
    long lq = (long)strlen(qual);
    if (lq > l) lq = l;
    for (long i = 0; i < lq; i++) {
      int q = (int)qual[i] - 33;
      f->sc_quals[i] = (uint8_t)(q < 0 ? 0 : (q > 255 ? 255 : q));
    }
    f->sc_has_quals = true;
  }
  f->sc_len = (size_t)l;
  f->sc_off = 0;
  return 1;
}

// Python's str.strip() set within ASCII: the whole-record path strips
// FASTA and FASTQ lines as the Python reader does
bool is_space(char c) {
  return c == ' ' || (c >= '\t' && c <= '\r') || (c >= 0x1c && c <= 0x1f);
}

// The line's bases as the Python reader keeps them: *p moves past
// leading and the length drops trailing whitespace.
long strip_line(const char **p, long len) {
  while (len > 0 && is_space(**p)) { (*p)++; len--; }
  while (len > 0 && is_space((*p)[len - 1])) len--;
  return len;
}

// The next record of the file into the scratch (sc_len bases, 0 for an
// empty record).  Returns 1, 0 at the end of the file, -1 on a parse
// error.  whole: the Python reader's rules, for mctx_seq_read_records:
// the first line, blank or not, decides the format (a tab: SAM), and
// FASTA and FASTQ sequence and quality lines lose surrounding
// whitespace.  Otherwise blank lines before the first record are
// skipped, a '>' line is FASTA even with a tab, and lines are kept
// but for their line ends (mctx_seq_read_batch, as before).
int next_record(SeqFile *f, bool whole) {
  if (f->format == 3) {          // BAM
    for (;;) {
      int r = read_bam_record(f);
      if (r != 2) return r;
    }
  }
  for (;;) {
    long len;
    if (f->have_pending) {
      len = (long)strlen(f->pending);
      // swap pending into linebuf
      char *tmp = f->linebuf; size_t tcap = f->linecap;
      f->linebuf = f->pending; f->linecap = f->pendingcap;
      f->pending = tmp; f->pendingcap = tcap;
      f->have_pending = false;
    } else {
      len = read_line(f, &f->linebuf, &f->linecap);
      if (len < 0) return 0;
      if (len == 0 && !(whole && f->format == 0)) continue;
    }
    char first = f->linebuf[0];
    if (f->format == 0) {
      bool has_tab = strchr(f->linebuf, '\t') != nullptr;
      if (whole) {
        if (has_tab) f->format = 4;
        else if (first == '>') f->format = 1;
        else if (first == '@') f->format = 2;
        else return -1;
      } else if (first == '>') f->format = 1;
      else if (first == '@' && has_tab) f->format = 4;   // SAM header
      else if (first == '@') f->format = 2;
      else if (has_tab) f->format = 4;       // headerless SAM record
      else return -1;
    }
    if (f->format == 4) {                    // SAM
      if (first == '@') continue;            // header line
      if (parse_sam_line(f, f->linebuf) == 1) return 1;
      continue;
    }
    if (f->format == 1) {                    // FASTA
      if (first != '>') return -1;
      // accumulate sequence lines until next '>' or EOF
      size_t total = 0;
      for (;;) {
        long l2 = read_line(f, &f->pending, &f->pendingcap);
        if (l2 < 0) break;
        if (l2 == 0) continue;
        if (f->pending[0] == '>') { f->have_pending = true; break; }
        const char *p = f->pending;
        if (whole) l2 = strip_line(&p, l2);
        sc_reserve(f, total + (size_t)l2);
        for (long i = 0; i < l2; i++)
          f->sc_codes[total + i] = base_code[(uint8_t)p[i]];
        total += (size_t)l2;
      }
      f->sc_len = total;
      f->sc_off = 0;
      f->sc_has_quals = false;
      return 1;
    }
    // FASTQ
    if (first != '@') return -1;
    long l2 = read_line(f, &f->linebuf, &f->linecap);  // sequence
    if (l2 < 0) return -1;
    const char *p = f->linebuf;
    if (whole) l2 = strip_line(&p, l2);
    sc_reserve(f, (size_t)l2);
    for (long i = 0; i < l2; i++)
      f->sc_codes[i] = base_code[(uint8_t)p[i]];
    if (read_line(f, &f->linebuf, &f->linecap) < 0) return -1;  // '+'
    long l4 = read_line(f, &f->linebuf, &f->linecap);           // quals
    if (l4 < 0) return -1;
    p = f->linebuf;
    if (whole) l4 = strip_line(&p, l4);
    if (f->fq_offset == 0) {
      // auto-detect (ref seq_file): any char below '@' => phred+33
      int minc = 255;
      for (long i = 0; i < l4; i++)
        if ((int)(uint8_t)p[i] < minc) minc = (int)(uint8_t)p[i];
      f->fq_offset = (l4 == 0 || minc < 64) ? 33 : 64;
    }
    if (l4 > l2) l4 = l2;
    memset(f->sc_quals, 0, (size_t)l2);
    for (long i = 0; i < l4; i++) {
      int q = (int)p[i] - f->fq_offset;
      f->sc_quals[i] = (uint8_t)(q < 0 ? 0 : (q > 255 ? 255 : q));
    }
    f->sc_len = (size_t)l2;
    f->sc_off = 0;
    f->sc_has_quals = true;
    return 1;
  }
}

}  // namespace

void mctx_seq_close(void *h) {
  SeqFile *f = (SeqFile *)h;
  if (!f) return;
  gzclose(f->gz);
  free(f->linebuf);
  free(f->pending);
  free(f->sc_codes);
  free(f->sc_quals);
  delete f;
}

// Read up to max_reads rows; sequences longer than max_len continue in
// following rows with the handle's overlap shared bases (never truncated).
// codes:  (max_reads * max_len) u8, filled with 4 padding
// quals:  (max_reads * max_len) u8 phred scores (0 if absent)
// lens:   (max_reads) i32 emitted row lengths
// Returns number of rows produced, 0 at EOF, -1 on error.
long mctx_seq_read_batch(void *h, long max_reads, long max_len,
                         uint8_t *codes, uint8_t *quals, int32_t *lens) {
  SeqFile *f = (SeqFile *)h;
  memset(codes, 4, (size_t)max_reads * max_len);
  memset(quals, 0, (size_t)max_reads * max_len);
  long n = 0;

  // drain a chunked record carried over from the previous batch, then
  // chunk the following records (an empty record gives no row)
  for (;;) {
    while (f->sc_len > f->sc_off && n < max_reads) {
      sc_emit(f, max_len, codes + (size_t)n * max_len,
              quals + (size_t)n * max_len, lens + n);
      n++;
    }
    if (n == max_reads) return n;
    int r = next_record(f, false);
    if (r < 0) return -1;
    if (r == 0) return n;
  }
}

// Read up to max_reads whole records (never split or clipped) by the
// Python reader's rules (next_record's `whole`): an empty record is a
// record of length 0.  Record i's bases go to codes[o_i, o_i + lens[i])
// with o_i the sum of the earlier lengths, and its phred scores alike
// into quals (0 where the record has none); cap is the bytes each of
// codes and quals holds.
// Returns the number of records, 0 at the end of the file, -1 on a
// parse error, and -2 when the next record alone is longer than cap:
// lens[0] then holds its length, and the record waits for the next call.
long mctx_seq_read_records(void *h, long max_reads, long cap,
                           uint8_t *codes, uint8_t *quals, int32_t *lens) {
  SeqFile *f = (SeqFile *)h;
  long n = 0;
  size_t used = 0;
  while (n < max_reads) {
    if (!f->held) {
      int r = next_record(f, true);
      if (r < 0) return -1;
      if (r == 0) break;
      f->held = true;
    }
    size_t len = f->sc_len;
    if (used + len > (size_t)cap) {
      if (n > 0) break;
      lens[0] = (int32_t)len;
      return -2;
    }
    if (len > 0) {
      memcpy(codes + used, f->sc_codes, len);
      if (f->sc_has_quals) memcpy(quals + used, f->sc_quals, len);
      else memset(quals + used, 0, len);
    }
    lens[n++] = (int32_t)len;
    used += len;
    f->held = false;
  }
  return n;
}

}  // extern "C"
