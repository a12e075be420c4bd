"""Conformance layer: bit-exact interop with reference tmc3 bitstreams.

This package speaks the *reference* G-PCC syntax (as implemented by
MPEGGroup/mpeg-pcc-tmc13) rather than this framework's
own "syntax v1".  It exists to prove conformance: decoding a bitstream
produced by the tmc3 binary to the identical point cloud.

Modules:
  ref_hls   — reference TLV framing + SPS/GPS/GBH(+footer) bit parsing
              (counterpart of tmc3/io_hls.cpp, io_tlv.cpp)
  decoder   — geometry brick decode via the native bit-exact engine
              (native/refcodec.cc: schroarith + dirac OBUF contexts +
              octree decode semantics)
"""

from . import ref_hls  # noqa: F401
