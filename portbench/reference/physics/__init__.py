# Frozen copy of mistra_tpu_torch/physics/__init__.py (lines 1-1, commit b2518445).
"""Column physics of the PyTorch port (one module per JAX counterpart)."""
