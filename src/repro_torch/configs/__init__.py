"""repro_torch.configs — the architecture/shape inventory (``base``) and
the architectures that register in it (``registry``)."""
