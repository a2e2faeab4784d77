"""Host-side DNA string helpers; copy of mccortex_tpu/utils/dna.py."""

_COMP = str.maketrans("ACGTacgt", "TGCAtgca")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def canonical_str(s: str) -> str:
    rc = revcomp(s)
    return s if s <= rc else rc
