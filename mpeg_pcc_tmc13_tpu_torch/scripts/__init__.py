"""The evaluation loop on the port (the repo's ``scripts/``): CTC-style
input clouds, the cross-config conformance matrix, the rate-distortion
parity harness, the cfg-tree tools and the mesh-scaling check, each the
port's copy of the reference script, driving ``tmc3-cuda``.

Each module runs as ``python -m mpeg_pcc_tmc13_tpu_torch.scripts.<name>``.
"""
