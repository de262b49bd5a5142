"""geometry sub-package of the PyTorch port."""
