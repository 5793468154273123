# Frozen copy of mistra_tpu_torch/radiation/__init__.py (lines 1-2, commit b2518445).
"""PIFM2 radiation of the PyTorch port (input tables, delta-two-stream
solver, driver), batched over columns."""
