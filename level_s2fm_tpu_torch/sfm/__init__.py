"""sfm sub-package of the PyTorch port."""
