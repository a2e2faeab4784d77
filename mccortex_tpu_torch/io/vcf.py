"""Minimal VCF text IO; a copy of mccortex_tpu/io/vcf.py whose
`##source=` header names this package (role of the htslib VCF subset
the reference links: read/write records with INFO/FORMAT fields;
ctx_calls2vcf.c / ctx_vcfcov.c / ctx_vcfgeno.c consumers).  Plain or
gzipped text; the binary BCF 2.2 container lives in io/bcf.py.
"""

from __future__ import annotations

import dataclasses
import gzip

from .. import __version__


@dataclasses.dataclass
class VcfRecord:
    chrom: str
    pos: int          # 0-based internally; serialised 1-based
    vid: str
    ref: str
    alts: list
    qual: str = "."
    filt: str = "PASS"
    info: dict = dataclasses.field(default_factory=dict)
    fmt: list = dataclasses.field(default_factory=list)
    samples: list = dataclasses.field(default_factory=list)  # [dict]


@dataclasses.dataclass
class VcfFile:
    headers: list                  # meta lines without trailing newline
    sample_names: list
    records: list


def _opener(path, mode):
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t")
    return open(path, mode)


def read_vcf(path: str) -> VcfFile:
    headers, samples, records = [], [], []
    with _opener(path, "r") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("##"):
                headers.append(line)
            elif line.startswith("#CHROM"):
                cols = line.split("\t")
                samples = cols[9:]
            else:
                f = line.split("\t")
                info = {}
                if len(f) > 7 and f[7] != ".":
                    for kv in f[7].split(";"):
                        if "=" in kv:
                            k, v = kv.split("=", 1)
                            info[k] = v
                        else:
                            info[kv] = True
                fmt = f[8].split(":") if len(f) > 8 else []
                smps = []
                for s in f[9:]:
                    vals = s.split(":")
                    smps.append({k: (vals[i] if i < len(vals) else ".")
                                 for i, k in enumerate(fmt)})
                records.append(VcfRecord(
                    chrom=f[0], pos=int(f[1]) - 1, vid=f[2], ref=f[3],
                    alts=f[4].split(","), qual=f[5] if len(f) > 5 else ".",
                    filt=f[6] if len(f) > 6 else ".",
                    info=info, fmt=fmt, samples=smps))
    return VcfFile(headers=headers, sample_names=samples, records=records)


def write_vcf(path: str, vcf: VcfFile) -> None:
    with _opener(path, "w") as fh:
        _write_vcf_fh(fh, vcf)


def _write_vcf_fh(fh, vcf: VcfFile) -> None:
    for h in vcf.headers:
        fh.write(h + "\n")
    cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER",
            "INFO"]
    if vcf.sample_names:
        cols += ["FORMAT"] + list(vcf.sample_names)
    fh.write("\t".join(cols) + "\n")
    for r in vcf.records:
        info = ";".join(
            k if v is True else f"{k}={v}" for k, v in r.info.items()) \
            or "."
        f = [r.chrom, str(r.pos + 1), r.vid, r.ref, ",".join(r.alts),
             r.qual, r.filt, info]
        if r.fmt:
            f.append(":".join(r.fmt))
            for s in r.samples:
                f.append(":".join(str(s.get(k, ".")) for k in r.fmt))
        fh.write("\t".join(f) + "\n")


def std_headers(ref_path: str | None = None, contigs=None,
                extra=None) -> list:
    hdr = ["##fileformat=VCFv4.2",
           f"##source=mccortex_tpu_torch-{__version__}"]
    if ref_path:
        hdr.append(f"##reference={ref_path}")
    for name, length in (contigs or []):
        hdr.append(f"##contig=<ID={name},length={length}>")
    hdr += extra or []
    return hdr


def read_variants(path: str) -> "VcfFile":
    """Extension-dispatched variant reader: .bcf -> binary BCF2.2,
    otherwise text VCF (.gz ok) — ref vcf_misc.h hts mode detection."""
    if path.endswith(".bcf"):
        from . import bcf as _bcf
        return _bcf.read_bcf(path)
    return read_vcf(path)


def write_variants(path: str, vcf: "VcfFile", fmt: str | None = None) -> None:
    """fmt: vcf|vcfgz|bcf|ubcf (ref -O/--out-fmt, vcf_misc.c
    hts_mode_of); None = dispatch on extension (.bcf binary, .gz
    gzip text, else plain text)."""
    from . import bcf as _bcf
    if fmt is None:
        fmt = "bcf" if path.endswith(".bcf") else None
    if fmt == "bcf":
        _bcf.write_bcf(path, vcf)
    elif fmt == "ubcf":
        _bcf.write_bcf(path, vcf, compressed=False)
    elif fmt == "vcfgz":
        import io as _io
        buf = _io.StringIO()
        _write_vcf_fh(buf, vcf)
        with open(path, "wb") as fh:
            _bcf._bgzf_write(fh, buf.getvalue().encode())
    else:
        write_vcf(path, vcf)
