"""mpeg_pcc_tmc13_tpu_torch — the G-PCC device pipeline on PyTorch + CUDA.

A port of the device path of ``mpeg_pcc_tmc13_tpu`` (JAX on a TPU) to
PyTorch on an NVIDIA Hopper card.  The JAX package stays beside it as the
reference: every module here names its counterpart, keeps its public
names and layouts, and is tested against it on the same inputs.

What is ported (the device round trip that ``bench.py`` drives):

* geometry encode: sorted Morton codes -> level-major occupancy bytes on
  the device (``ops.octree``) -> two-step fetch -> native host range
  coder (``runtime.device_pipeline``),
* geometry decode: host entropy decode -> leaf codes rebuilt on the
  device,
* colour attributes: the fixed-point RAHT closed loop on int64 tensors
  (``ops.raht_fp_device``),
* the float RAHT lane (``ops.raht_device``) over the two hand-written
  CUDA block-butterfly kernels (``csrc/raht_blocks.cu``,
  ``ops.raht_blocks``).

The jax-free host layer of the reference package (the native range
coder ``bitstream.entropy``, the numpy fixed-point RAHT spec and its
planner) is shared, not copied.  This package never imports jax.

Importing it needs no GPU.  Public entry points take an explicit
``device``; a CPU tensor runs the plain PyTorch versions of the kernels,
a CUDA tensor launches the kernels (built with ``nvcc`` on first use)
or raises.
"""

__version__ = "0.1.0"
