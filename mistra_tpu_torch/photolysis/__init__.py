"""Photolysis of the PyTorch port (input tables, delta-four-stream actinic
flux solver, J-rate driver), batched over columns."""
