"""cpp sub-package of the PyTorch port."""
