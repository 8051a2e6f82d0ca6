"""Observability: the Chrome-trace recorder, the torch.profiler device
profile and the per-operator metrics tree."""
