"""Data side of the port: corpus readers, per-sample assembly, loaders."""
