"""PyTorch + CUDA port of the Radar DataTree framework (NVIDIA H100).

A package of its own beside the JAX reference package ``repro``: it keeps
its own copies of the numpy-only layers it needs (store, core, etl,
geometry), so it never imports ``repro`` or ``jax``.  The archive format
is byte-identical, so archives written by either package read back
bitwise through the other.

It covers the paper's two case studies read from the versioned archive
(``repro_torch.radar.products.compute_product`` for the quasi-vertical
profile and Z-R accumulation), the Cartesian and incremental products
(``repro_torch.radar.grid``, ``.incremental``), and serving the
radar-token LM and zamba2 (``repro_torch.serve.Engine``, ``python -m
repro_torch.launch.serve``), carried by the hand-written CUDA kernels in
``repro_torch.kernels``.
"""
