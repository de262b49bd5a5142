"""viz sub-package of the PyTorch port."""
