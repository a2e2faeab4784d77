"""Published peaks of the card, against which roofline shares are stated
(NVIDIA's H100 SXM data sheet, at its full 700 W power limit: the result
line records the card's own limit beside every share)."""

HBM_BYTES_PER_S = 3.35e12      # HBM3, 80 GB
