"""LM serving: the continuous-batching decode server (``engine``)."""
