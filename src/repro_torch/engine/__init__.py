"""repro_torch.engine — slab packing, solver backends and the engine
registry of the grouped Bellman–Ford data plane."""
