"""Numerical utilities of the PyTorch port."""
