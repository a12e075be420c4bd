"""Slice-parallel encoding over several torch devices: counterpart of
``mpeg_pcc_tmc13_tpu/parallel/``.

``slices`` holds the mesh forms (sharded analysis with its histogram
reduce, inter analysis, the block butterflies, the codec round trip),
``frame`` the per-slice placement of a frame's encode and decode, and
``dryrun`` the multi-device dry run of both.
"""
