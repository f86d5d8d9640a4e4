"""repro_torch.kernels — hand-written Hopper kernels (``csrc/``), their
builds, launchers, counted wrappers (``ops``) and plain versions
(``ref``)."""
