# Frozen copy of mistra_tpu_torch/parallel/__init__.py (lines 1-1, commit b2518445).
"""Column ensembles over more than one card."""
