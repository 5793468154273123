"""Run output of the PyTorch port: checkpoints, science output (netCDF
through the native writer, or numpy files), hourly ASCII profiles."""
