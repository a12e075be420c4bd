"""L1 + L3: entropy coding, bit I/O, TLV framing, high-level syntax."""
