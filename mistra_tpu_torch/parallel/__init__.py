"""Column ensembles over more than one card."""
