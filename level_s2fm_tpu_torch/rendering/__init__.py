"""rendering sub-package of the PyTorch port."""
