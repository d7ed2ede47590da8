"""Launch helpers of the PyTorch port: ``mesh`` (the device mesh of the
data-parallel sharded step) and ``serve`` (the serve CLI over synthetic
hazy video)."""
