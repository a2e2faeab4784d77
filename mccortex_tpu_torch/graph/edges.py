"""Edge-byte helpers; counterpart of mccortex_tpu/graph/edges.py.

One byte per kmer per colour.  Bit (nuc + 4*orient) set means:
traversing the stored key in `orient`ation, the next base is `nuc`.  The
low nibble is FORWARD (next) edges; the high nibble is REVERSE-
orientation edges, i.e. complements of preceding bases.  Orientations
and nucleotides may be tensors or ints; results are on edges' device.
"""

import numpy as np
import torch

# reverse the bit order of a nibble (ref: db_node.h rev_nibble_lookup)
REV_NIBBLE = np.array([0b0000, 0b1000, 0b0100, 0b1100,
                       0b0010, 0b1010, 0b0110, 0b1110,
                       0b0001, 0b1001, 0b0101, 0b1101,
                       0b0011, 0b1011, 0b0111, 0b1111], dtype=np.uint8)

POPCOUNT4 = np.array([bin(i).count("1") for i in range(16)], dtype=np.uint8)


def table(arr: np.ndarray, device) -> torch.Tensor:
    """A small lookup table as a tensor on `device`."""
    return torch.from_numpy(arr).to(device)


def _i64(x, device):
    return torch.as_tensor(x, device=device).to(torch.int64)


def edge_bit(nuc, orient):
    """1 << (nuc + 4*orient) as uint8."""
    nuc = torch.as_tensor(nuc).to(torch.int64)
    return (1 << (nuc + (_i64(orient, nuc.device) << 2))).to(torch.uint8)


def with_orientation(edges: torch.Tensor, orient) -> torch.Tensor:
    """Nibble of next-edges when traversing in `orient`."""
    sh = _i64(orient, edges.device) << 2
    return ((edges.to(torch.int64) >> sh) & 0xF).to(torch.uint8)


def outdegree(edges: torch.Tensor, orient) -> torch.Tensor:
    nib = with_orientation(edges, orient)
    return table(POPCOUNT4, edges.device)[nib.to(torch.int64)]


def indegree(edges: torch.Tensor, orient) -> torch.Tensor:
    return outdegree(edges, 1 - _i64(orient, edges.device))


def has_edge(edges: torch.Tensor, nuc, orient) -> torch.Tensor:
    sh = _i64(nuc, edges.device) + (_i64(orient, edges.device) << 2)
    return ((edges.to(torch.int64) >> sh) & 1).to(torch.bool)


def as_fw_nibble(edges: torch.Tensor, orient) -> torch.Tensor:
    """Edges on the forward strand regardless of orientation."""
    hi = ((edges.to(torch.int64) >> 4) & 0xF)
    rev = table(REV_NIBBLE, edges.device)[hi]
    return torch.where(_i64(orient, edges.device).to(torch.bool), rev,
                       edges & 0xF)


def union_colours(edges: torch.Tensor) -> torch.Tensor:
    """OR edge bytes across the colour axis (last axis)."""
    out = edges[..., 0]
    for c in range(1, edges.shape[-1]):
        out = out | edges[..., c]
    return out
