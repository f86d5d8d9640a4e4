"""repro_torch.data — synthetic road networks and weight-update streams."""
