"""CLI entry of the port's scene preparation.

    python -m level_s2fm_tpu_torch.prepare --data D --scene S \
        [--backend auto|sift|colmap] [--max_kypts N] [--sift_contrast F] \
        [--no_guided] [--guided_px F] [--guided_ratio F]

Writes ``n_views.npy``, ``pose_graph.npy`` and ``two_view.npy`` into
``D/S`` (``preparation/main.py`` of this package). Host only: it touches
no device. The SIFT backend needs OpenCV; the COLMAP backend needs the
``colmap`` binary unless ``D/S/colmap_ws/database.db`` already exists.
"""
from __future__ import annotations

from .preparation.main import main

if __name__ == "__main__":
    main()
