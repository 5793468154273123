# Frozen copy of mistra_tpu_torch/photolysis/__init__.py (lines 1-2, commit b2518445).
"""Photolysis of the PyTorch port (input tables, delta-four-stream actinic
flux solver, J-rate driver), batched over columns."""
