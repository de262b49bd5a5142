"""fields sub-package of the PyTorch port."""
