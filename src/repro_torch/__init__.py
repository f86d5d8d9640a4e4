"""repro_torch — the PyTorch and CUDA port of the KSP-DG system.

A second package beside the JAX reference ``repro``: the same module
names, PyTorch idiom inside (plain functions on tensors, an explicit
``device``), and hand-written Hopper kernels under ``csrc/`` in place of
the Pallas TPU kernels.  It imports neither ``jax`` nor ``repro``.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.

    from repro_torch.service import KSPService, ServiceConfig
    svc = KSPService.build(graph, ServiceConfig(engine="cuda_bf"))
"""
