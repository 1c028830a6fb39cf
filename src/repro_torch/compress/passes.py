"""Compression passes (reference ``repro.compress.passes``).  Only the
weight-width aliases are ported so far: the passes themselves are ROADMAP
A6."""

# Weight-width aliases: the paper speaks in fixed-point formats (Q15/Q7),
# the storage speaks in integer widths (int16/int8).  Accept both.
BITS_ALIASES = {15: 16, 16: 16, 7: 8, 8: 8}
