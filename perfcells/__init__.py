"""The port's benchmark: cells, configurations, traffic and per-layer
metrics as files, driven by `run.py` (see README.md)."""
