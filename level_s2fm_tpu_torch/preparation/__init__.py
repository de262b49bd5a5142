"""preparation sub-package of the PyTorch port: keypoints, matches and the
pose graph of a photo set (``main``), and the COLMAP database (``colmap_db``)."""
