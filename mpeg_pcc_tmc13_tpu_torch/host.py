"""The host-side names callers of the port need, from the port's own
host layer: the native range coder (``bitstream/entropy.py``, over the
library built from ``native/``), the numpy fixed-point RAHT spec
(``ops/raht_fp.py``), PLY I/O (``utils/ply.py``) and the TLV framing of
the streams (``bitstream/tlv.py``).

Each is a copy of the JAX package's module of the same relative path,
with only its imports changed; none of them reaches jax or the JAX
package.
"""

from .bitstream import tlv  # noqa: F401
from .bitstream.entropy import (  # noqa: F401
    RangeDecoder, RangeEncoder, native_available)
from .ops.raht_fp import (  # noqa: F401
    forward_predicted_fp, inverse_predicted_fp)
from .utils import ply  # noqa: F401
