"""repro_torch.launch — drivers: ``serve`` (cluster serving), ``train``
(any registered arch, checkpointed and resumable) and ``mesh`` (device
meshes and the ``torch.distributed`` init hook)."""
