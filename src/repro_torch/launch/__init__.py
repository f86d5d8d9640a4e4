"""repro_torch.launch — drivers: ``serve`` (cluster serving) and ``mesh``
(device meshes and the ``torch.distributed`` init hook)."""
