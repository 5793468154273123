"""Chemistry of the PyTorch port: the stiff multiphase solve (mechanism
parser, rate laws, Ros3, block-arrow stage solver, batched inverse)."""
