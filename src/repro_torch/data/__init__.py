"""repro_torch.data — synthetic road networks, weight-update streams, the
DIMACS .gr loader, and the training pipelines of every family
(``pipeline``)."""
