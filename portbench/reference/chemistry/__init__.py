# Frozen copy of mistra_tpu_torch/chemistry/__init__.py (lines 1-2, commit b2518445).
"""Chemistry of the PyTorch port: the stiff multiphase solve (mechanism
parser, rate laws, Ros3, block-arrow stage solver, batched inverse)."""
