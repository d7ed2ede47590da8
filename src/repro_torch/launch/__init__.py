"""Launch helpers of the PyTorch port: ``mesh`` (the device mesh of the
data-parallel sharded step)."""
