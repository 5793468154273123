"""PIFM2 radiation of the PyTorch port (input tables, delta-two-stream
solver, driver), batched over columns."""
