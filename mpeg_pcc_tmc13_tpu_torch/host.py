"""The jax-free host layer the port shares with ``mpeg_pcc_tmc13_tpu``
instead of copying it: the native range coder
(``bitstream/entropy.py``), the numpy fixed-point RAHT spec
(``ops/raht_fp.py``), PLY I/O (``utils/ply.py``) and the TLV framing of
the streams (``bitstream/tlv.py``).

Callers of the port take these names from here, so they name only this
package; none of these modules reaches jax.
"""

from mpeg_pcc_tmc13_tpu.bitstream import tlv  # noqa: F401
from mpeg_pcc_tmc13_tpu.bitstream.entropy import (  # noqa: F401
    RangeDecoder, RangeEncoder, native_available)
from mpeg_pcc_tmc13_tpu.ops.raht_fp import (  # noqa: F401
    forward_predicted_fp, inverse_predicted_fp)
from mpeg_pcc_tmc13_tpu.utils import ply  # noqa: F401
