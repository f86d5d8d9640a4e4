"""repro_torch.data — synthetic road networks, weight-update streams and
the DIMACS .gr loader."""
