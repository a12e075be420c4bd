"""mpeg_pcc_tmc13_tpu_torch — the G-PCC device pipeline on PyTorch + CUDA.

A port of the device path of ``mpeg_pcc_tmc13_tpu`` (JAX on a TPU) to
PyTorch on an NVIDIA Hopper card.  The JAX package stays beside it as the
reference: every module here names its counterpart, keeps its public
names and layouts, and is tested against it on the same inputs.

What is ported:

* the device round trip that ``bench.py`` drives
  (``runtime.roundtrip``): geometry encode (sorted Morton codes ->
  level-major occupancy bytes on the device, ``ops.octree`` -> raw or
  packed two-step fetch -> native host range coder,
  ``runtime.device_pipeline``), geometry decode (host entropy decode ->
  leaf codes rebuilt on the device), the fixed-point RAHT closed loop
  on int64 tensors (``ops.raht_fp_device``) and the float RAHT lane
  (``ops.raht_device``) over two hand-written CUDA block-butterfly
  kernels (``csrc/raht_blocks.cu``, ``ops.raht_blocks``),
* the octree geometry codec (``models.geometry_octree``) with its
  numpy, native and device engines (the device one runs the full
  analysis of ``ops.octree`` on a torch device),
* the on-device rANS geometry engine (``models.geometry_rans``,
  ``ops.octree_rans``) over three hand-written CUDA lane kernels
  (``csrc/rans_lanes.cu``, ``ops.rans_lanes``),
* the frame codec and its tmc3-compatible CLI (``runtime.encoder``,
  ``runtime.decoder``, ``runtime.cli``, script ``tmc3-cuda``) with the
  host modules they run: the attribute codecs (``models.attr_raht``,
  ``attr_predlift``, ``attributes``), predictive and OBUF geometry,
  quantisation, partitioning, recolouring, motion and levels of detail.
  Trisoup geometry and the tmc3 syntax family are not ported yet.

The jax-free host layer of the reference package (the native range
coder, the numpy fixed-point RAHT spec and its planner, the angular
laser helpers, the bitstream syntax, PLY I/O, the conformance
parameter sets) is shared, not copied; ``host`` re-exports what callers
of the port need from it.  Code that reaches jax only through its
Morton codes is copied here with the port's ``utils.morton``: whole
modules (the frame codec above) or single functions
(``ops.angular.node_angular_ctx``, ``models.attributes.encode``/
``decode``, ``models.geometry_obuf.decode``).  This package never
imports jax.

Importing it needs no GPU.  Public entry points take a ``device``; the
model engines (``models.geometry_rans``, ``models.geometry_octree``'s
``"device"`` engine) default to the current CUDA device and raise
without one.  A CPU tensor runs the plain PyTorch versions of the
kernels, a CUDA tensor launches the kernels (built with ``nvcc`` on
first use) or raises.
"""

__version__ = "0.1.0"
