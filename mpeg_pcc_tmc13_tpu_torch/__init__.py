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
  quantisation, partitioning, recolouring, motion and levels of detail,
* trisoup geometry (``models.geometry_trisoup`` over ``ops.trisoup``,
  the one trisoup module, and ``ops.trisoup_ref``): the numpy surface
  model behind the octree front-end of any engine, or the
  reference-exact brick under ``--geomEngine=obuf``,
* the tmc3 syntax family (``conformance``: encoder, decoder and
  ``ref_hls`` over the native engine; ``--refSyntax=1`` in the CLI),
  host code that asks for no device,
* ``tools.ply_merge`` (merge frames tagged by ``frameindex``, split),
* the multi-device layer (``parallel``): the slice mesh over torch
  devices (sharded analysis with its histogram reduce, inter analysis,
  the float block butterfly and the fixed-point one, whose hand-written
  CUDA kernel is ``csrc/raht_fp_blocks.cu``), the per-slice placement of
  a frame's encode and decode, and the dry run ``dryrun_multichip``.

Nothing of the JAX package is left to port.

The package stands alone: it imports neither jax nor anything of
``mpeg_pcc_tmc13_tpu``.  The host layer it needs from the reference
package is copied under the same relative paths, with only the imports
changed, so each copy names its counterpart by its path: the range
coder and bitstream syntax (``bitstream/``), PLY I/O, option parsing
and timing (``utils/``), the point cloud and frame store, the numpy
RAHT specs and their planner (``ops/raht.py``, ``raht_fp.py``, the
host planner in ``raht_fp_device.py``: the spec of ``raht_plan.py``),
the angular and coordinate helpers,
the tmc3-syntax codec (``conformance/``) and the C++ of the native
library (``native/``, thirteen translation units), which
``bitstream.entropy`` builds with ``g++`` into ``build/tmc13_native/``
on first import.  ``host`` re-exports what callers need from it.

Importing it needs no GPU.  Public entry points take a ``device``
and default to the current CUDA device, raising ``utils.device.
NoDeviceError`` without one (pass ``device="cpu"`` to run on the
host).  A CPU tensor runs the plain PyTorch versions of the
kernels, a CUDA tensor launches the kernels (built with ``nvcc`` on
first use) or raises.
"""

__version__ = "0.1.0"
