"""repro_torch.launch — drivers: ``serve`` (cluster serving), ``train``
(any registered arch, checkpointed and resumable), ``mesh`` (device
meshes and the ``torch.distributed`` init hook), ``dryrun`` (every cell
traced on the meta device and costed by ``roofline`` in H100 terms),
``rooffit`` (the LM cells' terms fitted over depth), ``report`` and
``experiments_md`` (tables from the records) and the hill-climbs
``hillclimb_gemma`` and ``hillclimb_bst``."""
