"""BCF 2.2 read/write (binary VCF); a copy of mccortex_tpu/io/bcf.py
(standard library and numpy only).  Role of ref src/graph/vcf_misc.h +
htslib usage in ctx_vcfcov.c / ctx_vcfgeno.c ("detect vcf/vcf.gz/bcf
by extension").

Spec: samtools hts-specs VCFv4.x section 6 (BCF encoding).  The writer
emits real BGZF blocks (gzip members with the BC/BSIZE extra subfield
and the 28-byte EOF marker) so files are htslib-compatible; the reader
accepts any concatenated-gzip stream (python gzip traverses members).

Supported value encodings: int8/16/32 scalars + vectors, float, char
strings, flags, and the missing value sentinels — everything our
VcfRecord model produces (INFO, FILTER, per-sample FORMAT fields).
"""

from __future__ import annotations

import gzip
import struct
import zlib

import numpy as np

from .vcf import VcfFile, VcfRecord

_MAGIC = b"BCF\x02\x02"
_INT8_MISSING = -128
_INT16_MISSING = -32768
_INT32_MISSING = -2147483648
_INT8_EOV = -127           # END_OF_VECTOR sentinels (spec table 4)
_INT16_EOV = -32767
_INT32_EOV = -2147483647
_FLOAT_MISSING = struct.unpack("<f", struct.pack("<I", 0x7F800001))[0]


# ---------------------------------------------------------------------------
# BGZF container
# ---------------------------------------------------------------------------

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _bgzf_block(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = 12 + 6 + len(comp) + 8   # header + xtra + comp + crc/isize
    head = (b"\x1f\x8b\x08\x04" + b"\x00" * 6 +
            struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2,
                                                       bsize - 1))
    tail = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                       len(data) & 0xFFFFFFFF)
    return head + comp + tail


def _bgzf_write(fh, data: bytes):
    CHUNK = 60000
    for s in range(0, len(data), CHUNK):
        fh.write(_bgzf_block(data[s:s + CHUNK]))
    fh.write(_BGZF_EOF)


# ---------------------------------------------------------------------------
# typed values
# ---------------------------------------------------------------------------

def _typed_size(n: int, btype: int) -> bytes:
    if n < 15:
        return bytes([(n << 4) | btype])
    return bytes([(15 << 4) | btype]) + _typed_int(n)


def _typed_int(v: int) -> bytes:
    if -120 <= v <= 127:
        return bytes([(1 << 4) | 1]) + struct.pack("<b", v)
    if -32000 <= v <= 32767:
        return bytes([(1 << 4) | 2]) + struct.pack("<h", v)
    return bytes([(1 << 4) | 3]) + struct.pack("<i", v)


def _typed_ints(vals) -> bytes:
    """Vector of ints with the smallest common width."""
    if not vals:
        return b"\x00"
    lo, hi = min(vals), max(vals)
    if -120 <= lo and hi <= 127:
        return _typed_size(len(vals), 1) + struct.pack(
            f"<{len(vals)}b", *vals)
    if -32000 <= lo and hi <= 32767:
        return _typed_size(len(vals), 2) + struct.pack(
            f"<{len(vals)}h", *vals)
    return _typed_size(len(vals), 3) + struct.pack(
        f"<{len(vals)}i", *vals)


def _typed_str(s: str) -> bytes:
    b = s.encode()
    return _typed_size(len(b), 7) + b


def _typed_missing() -> bytes:
    return b"\x00"


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def u(self, fmt):
        v = struct.unpack_from(fmt, self.d, self.o)
        self.o += struct.calcsize(fmt)
        return v[0] if len(v) == 1 else v

    def typed(self):
        """Returns (type, list-of-values)."""
        desc = self.d[self.o]
        self.o += 1
        n, t = desc >> 4, desc & 0xF
        if n == 15:
            _t2, vals = self.typed()
            n = vals[0]
        if t == 0:
            return t, []
        if t == 1:
            return t, list(self.u(f"<{n}b") if n > 1 else (self.u("<b"),))
        if t == 2:
            return t, list(self.u(f"<{n}h") if n > 1 else (self.u("<h"),))
        if t == 3:
            return t, list(self.u(f"<{n}i") if n > 1 else (self.u("<i"),))
        if t == 5:
            return t, list(self.u(f"<{n}f") if n > 1 else (self.u("<f"),))
        if t == 7:
            s = self.d[self.o:self.o + n].decode()
            self.o += n
            return t, [s]
        raise ValueError(f"BCF: unsupported type {t}")


# ---------------------------------------------------------------------------
# header dictionaries
# ---------------------------------------------------------------------------

def _build_dicts(headers, records, sample_names):
    """(dict_ids, contig_ids, extra_header_lines): the string dictionary
    (FILTER/INFO/FORMAT ids; PASS at index 0) and contig dictionary, in
    IDX order, synthesising header lines for undeclared keys."""
    import re
    ids = ["PASS"]
    contigs = []
    declared = set()
    for h in headers:
        m = re.match(r"##(FILTER|INFO|FORMAT)=<ID=([^,>]+)", h)
        if m and m.group(2) not in ids:
            ids.append(m.group(2))
            declared.add((m.group(1), m.group(2)))
        m = re.match(r"##contig=<ID=([^,>]+)", h)
        if m:
            contigs.append(m.group(1))
    extra = []
    for r in records:
        if r.chrom not in contigs:
            contigs.append(r.chrom)
            extra.append(f"##contig=<ID={r.chrom}>")
        for f in (r.filt or "PASS").split(";"):
            if f not in ("", ".") and f not in ids:
                ids.append(f)
                extra.append(f"##FILTER=<ID={f},Description=\".\">")
        for key, v in r.info.items():
            if key not in ids:
                ids.append(key)
                t = ("Flag" if v is True else
                     "Integer" if isinstance(v, (int, np.integer)) else
                     "Float" if isinstance(v, float) else "String")
                num = "0" if v is True else "1"
                extra.append(f"##INFO=<ID={key},Number={num},Type={t},"
                             f"Description=\".\">")
        for key in r.fmt:
            if key not in ids:
                ids.append(key)
                extra.append(f"##FORMAT=<ID={key},Number=1,"
                             f"Type=Integer,Description=\".\">")
    return ids, contigs, extra


def write_bcf(path: str, vcf: VcfFile, compressed: bool = True) -> None:
    """compressed=False writes an uncompressed BCF stream ('ubcf',
    ref vcf_misc.c hts 'wbu' mode)."""
    ids, contigs, extra = _build_dicts(vcf.headers, vcf.records,
                                       vcf.sample_names)
    idx = {s: i for i, s in enumerate(ids)}
    cidx = {c: i for i, c in enumerate(contigs)}

    hdr_lines = list(vcf.headers) + extra
    if not any(h.startswith("##FILTER=<ID=PASS") for h in hdr_lines):
        hdr_lines.insert(1 if hdr_lines else 0,
                         "##FILTER=<ID=PASS,Description=\"All filters "
                         "passed\">")
    cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER",
            "INFO"]
    if vcf.sample_names:
        cols += ["FORMAT"] + list(vcf.sample_names)
    text = "\n".join(hdr_lines + ["\t".join(cols)]) + "\n\x00"

    body = bytearray()
    body += _MAGIC
    tb = text.encode()
    body += struct.pack("<I", len(tb))
    body += tb
    nsmp = len(vcf.sample_names)
    for r in vcf.records:
        shared = bytearray()
        shared += struct.pack("<ii", cidx[r.chrom], r.pos)
        shared += struct.pack("<i", len(r.ref))
        qual = _FLOAT_MISSING if r.qual in (".", "", None) \
            else float(r.qual)
        shared += struct.pack("<f", qual)
        n_allele = 1 + len(r.alts)
        shared += struct.pack("<HH", len(r.info), n_allele)
        shared += struct.pack("<I", (len(r.fmt) << 24) | nsmp)
        shared += _typed_str(r.vid) if r.vid not in (None, "", ".") \
            else _typed_missing()
        shared += _typed_str(r.ref)
        for a in r.alts:
            shared += _typed_str(a)
        filts = [idx[f] for f in (r.filt or "PASS").split(";")
                 if f not in ("", ".")]
        shared += _typed_ints(filts)
        for key, v in r.info.items():
            shared += _typed_int(idx[key])
            if v is True:
                shared += _typed_missing()
            elif isinstance(v, (int, np.integer)):
                shared += _typed_int(int(v))
            elif isinstance(v, float):
                shared += _typed_size(1, 5) + struct.pack("<f", v)
            else:
                shared += _typed_str(str(v))
        indiv = bytearray()
        for key in r.fmt:
            indiv += _typed_int(idx[key])
            vals = [smp.get(key, ".") if i < len(r.samples) else "."
                    for i, smp in enumerate(
                        r.samples + [{}] * (nsmp - len(r.samples)))]
            if key == "GT":
                # spec GT int coding (VCFv4.x section 6.3.3):
                # (allele+1)<<1 | phased, 0 = missing allele, short
                # genotypes padded with END_OF_VECTOR — this is what
                # htslib emits and expects, so GT must never take the
                # generic char path
                import re as _re
                gts = []
                for gstr in (str(v) for v in vals):
                    if gstr in (".", "", "None"):
                        gts.append([0])
                        continue
                    toks = _re.split("([/|])", gstr)
                    alleles, seps = toks[0::2], toks[1::2]
                    vec = []
                    for j, a in enumerate(alleles):
                        ph = 1 if (j > 0 and seps[j - 1] == "|") else 0
                        vec.append(0 if a == "." else
                                   (((int(a) + 1) << 1) | ph))
                    gts.append(vec)
                P = max(len(v) for v in gts)
                flat = []
                for vec in gts:
                    flat += vec + [_INT8_EOV] * (P - len(vec))
                indiv += _typed_size(P, 1) + struct.pack(
                    f"<{nsmp * P}b", *flat)
                continue
            if all(isinstance(v, (int, np.integer)) or v == "."
                   for v in vals):
                ints = [int(v) if v != "." else _INT32_MISSING
                        for v in vals]
                lo = min(ints)
                hi = max(ints)
                if -120 <= lo and hi <= 127:
                    ints = [v if v != _INT32_MISSING else _INT8_MISSING
                            for v in ints]
                    indiv += _typed_size(1, 1) + struct.pack(
                        f"<{nsmp}b", *ints)
                elif -32000 <= lo and hi <= 32767:
                    ints = [v if v != _INT32_MISSING else _INT16_MISSING
                            for v in ints]
                    indiv += _typed_size(1, 2) + struct.pack(
                        f"<{nsmp}h", *ints)
                else:
                    indiv += _typed_size(1, 3) + struct.pack(
                        f"<{nsmp}i", *ints)
            else:
                ss = [str(v) for v in vals]
                w = max(len(s) for s in ss)
                indiv += _typed_size(w, 7)
                for s in ss:
                    indiv += s.ljust(w, "\x00").encode()
        body += struct.pack("<II", len(shared), len(indiv))
        body += shared
        body += indiv

    with open(path, "wb") as fh:
        if compressed:
            _bgzf_write(fh, bytes(body))
        else:
            fh.write(bytes(body))


def read_bcf(path: str) -> VcfFile:
    with gzip.open(path, "rb") as g:
        data = g.read()
    if data[:5] != _MAGIC:
        raise ValueError(f"{path}: not a BCF2.2 file")
    r = _Reader(data)
    r.o = 5
    l_text = r.u("<I")
    text = r.d[r.o:r.o + l_text].rstrip(b"\x00").decode()
    r.o += l_text
    headers = [l for l in text.split("\n") if l.startswith("##")]
    sample_names = []
    for l in text.split("\n"):
        if l.startswith("#CHROM"):
            sample_names = l.split("\t")[9:]
    ids, contigs, _ = _build_dicts(headers, [], sample_names)

    records = []
    n = len(r.d)
    while r.o + 8 <= n:
        l_shared, l_indiv = r.u("<II")
        end = r.o + l_shared + l_indiv
        chrom_i, pos = r.u("<ii")
        _rlen = r.u("<i")
        qual = r.u("<f")
        n_info, n_allele = r.u("<HH")
        nfmt_smp = r.u("<I")
        n_fmt, n_smp = nfmt_smp >> 24, nfmt_smp & 0xFFFFFF
        _t, vid = r.typed()
        alleles = []
        for _ in range(n_allele):
            _t, s = r.typed()
            alleles.append(s[0])
        _t, filts = r.typed()
        info = {}
        for _ in range(n_info):
            _t, ki = r.typed()
            t, v = r.typed()
            key = ids[ki[0]]
            if t == 0:
                info[key] = True
            elif t == 7:
                info[key] = v[0]
            else:
                info[key] = v[0]
        fmt = []
        samples = [dict() for _ in range(n_smp)]
        while r.o < end and len(fmt) < n_fmt:
            _t, ki = r.typed()
            key = ids[ki[0]]
            fmt.append(key)
            desc = r.d[r.o]
            t = desc & 0xF
            if t == 7:
                nlen = desc >> 4
                r.o += 1
                for s in range(n_smp):
                    raw = r.d[r.o:r.o + nlen]
                    r.o += nlen
                    samples[s][key] = raw.rstrip(b"\x00").decode()
            else:
                # one typed descriptor covers all samples' vectors
                _t2, vals = _read_fmt_vector(r, n_smp)
                if key == "GT" and _t2 in (1, 2, 3):
                    eov = {1: _INT8_EOV, 2: _INT16_EOV,
                           3: _INT32_EOV}[_t2]
                    for s in range(n_smp):
                        v = vals[s]
                        vv = v if isinstance(v, list) else [v]
                        out = ""
                        for j, x in enumerate(vv):
                            if x == eov:
                                break
                            # coded alleles are >= 2 ((allele+1)<<1);
                            # 0/1 = missing, negative = sentinel
                            al = "." if x < 2 else str((x >> 1) - 1)
                            out += al if j == 0 else \
                                ("|" if x & 1 else "/") + al
                        samples[s][key] = out or "."
                    continue
                for s in range(n_smp):
                    v = vals[s]
                    if v in (_INT8_MISSING, _INT16_MISSING,
                             _INT32_MISSING):
                        samples[s][key] = "."
                    else:
                        samples[s][key] = v
        r.o = end
        qual_s = "." if struct.pack("<f", qual) == struct.pack(
            "<f", _FLOAT_MISSING) else f"{qual:g}"
        filt = ";".join(ids[f] for f in filts) if filts else "PASS"
        records.append(VcfRecord(
            chrom=contigs[chrom_i], pos=pos,
            vid=vid[0] if vid else ".", ref=alleles[0],
            alts=alleles[1:], qual=qual_s, filt=filt, info=info,
            fmt=fmt, samples=samples))
    return VcfFile(headers=headers, sample_names=sample_names,
                   records=records)


def _read_fmt_vector(r: _Reader, n_smp: int):
    """Read one FORMAT value vector: descriptor gives per-sample length;
    values for all samples follow."""
    desc = r.d[r.o]
    r.o += 1
    per, t = desc >> 4, desc & 0xF
    if per == 15:
        _t, v = r.typed()
        per = v[0]
    fmtc = {1: "b", 2: "h", 3: "i", 5: "f"}[t]
    out = []
    for _ in range(n_smp):
        vals = struct.unpack_from(f"<{per}{fmtc}", r.d, r.o)
        r.o += per * struct.calcsize(fmtc)
        out.append(vals[0] if per == 1 else list(vals))
    return t, out
