"""SfM checkpointing: field params + camera/point host state + optimizer.

Counterpart of ``level_s2fm_tpu/utils/checkpoint.py``, with the same
container, so that a checkpoint moves between the two packages either
way. Version 3: one ``.npz`` (a zip of raw arrays) with a JSON manifest
entry, readable with ``allow_pickle=False``:

- ``param_<i>``: the field parameters' leaves, their tree paths in the
  manifest as data (``["d", key]`` for a dict key, ``["s", index]`` for a
  list index), in sorted-key order;
- ``pose_para`` [C,6], ``cam_id`` [C], ``idx2d_<k>`` per camera;
- ``xyzs`` [P,3], and the feature tracks flattened into ``track_ptr`` /
  ``track_data`` [(camera position, keypoint index)];
- ``optim_<i>``: the most recent phase's optimizer state in the JAX
  layout (``sfm/optstate.py``), with its label in the manifest.

A save writes ``<path>.<pid>.tmp`` and renames it into place, so a
reader never sees a half-written file. Under data-parallel ranks rank 0
writes and every rank waits for it (a barrier); every rank reads.
Version 2 (a
pickle whose leaves are numpy arrays) is still read; version 1 pickled a
JAX treedef, which only the JAX package can rebuild, and raises here.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..parallel import distributed as pdist


def _tree_paths(params):
    """[(path spec, np.ndarray leaf)] of a dict/list tree of tensors, in
    the JAX package's flatten order (dict keys sorted)."""
    out = []

    def walk(node, spec):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], spec + [("d", k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, spec + [("s", i)])
        elif torch.is_tensor(node):
            out.append((spec, node.detach().cpu().numpy()))
        else:
            out.append((spec, np.asarray(node)))

    walk(params, [])
    return out


def _tree_from_paths(entries):
    def container_for(kind):
        return {} if kind == "d" else []

    root = container_for(entries[0][0][0][0]) if entries else {}
    for spec, leaf in entries:
        cur = root
        for i, (kind, k) in enumerate(spec):
            last = i == len(spec) - 1
            if kind == "s":
                while len(cur) <= k:
                    cur.append(None)
            if last:
                cur[k] = leaf
            else:
                nxt_kind = spec[i + 1][0]
                if kind == "d":
                    if k not in cur or cur[k] is None:
                        cur[k] = container_for(nxt_kind)
                else:
                    if cur[k] is None:
                        cur[k] = container_for(nxt_kind)
                cur = cur[k]
    return root


def save_checkpoint_sfm(path: str, params, cameraset, pointset,
                        it: int = 0, extra: Optional[dict] = None):
    from .obs import HOST_TIMERS
    with HOST_TIMERS.track("host_checkpoint"):
        if pdist.is_primary():
            _save_checkpoint_sfm(path, params, cameraset, pointset,
                                 it=it, extra=extra)
        pdist.barrier()


def _save_checkpoint_sfm(path, params, cameraset, pointset, it, extra):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    specs = []
    for i, (spec, leaf) in enumerate(_tree_paths(params)):
        arrays[f"param_{i}"] = leaf
        specs.append(spec)

    cam_info = cameraset.get_parameters()
    cam_ids = list(cam_info["cam_id"])
    arrays["pose_para"] = np.asarray(cam_info["pose_para"], np.float32)
    arrays["cam_id"] = np.asarray(cam_ids, np.int64)
    for k, m in enumerate(cam_info["idx2d_to_3ds"]):
        arrays[f"idx2d_{k}"] = np.asarray(m)

    pts_info = pointset.get_parameters()
    tracks = pts_info["feat_tracks"]
    ptr = np.zeros(len(tracks) + 1, np.int64)
    flat: List[Tuple[int, int]] = []
    for i, t in enumerate(tracks):
        ptr[i + 1] = ptr[i] + len(t)
        flat.extend((int(a), int(b)) for a, b in t)
    arrays["xyzs"] = np.asarray(pts_info["xyzs"], np.float32)
    arrays["track_ptr"] = ptr
    arrays["track_data"] = (np.asarray(flat, np.int64).reshape(-1, 2)
                            if flat else np.zeros((0, 2), np.int64))

    manifest = {"version": 3, "it": int(it), "extra": extra or {},
                "param_specs": specs, "n_cams": len(cam_ids), "optim": None}

    from ..sfm import optstate
    snap = optstate.snapshot()
    if snap is not None:
        label, leaves = snap
        for i, leaf in enumerate(leaves):
            arrays[f"optim_{i}"] = leaf
        manifest["optim"] = {"label": label, "n_leaves": len(leaves)}

    tmp = f"{path}.{os.getpid()}.tmp"     # private to this process
    with open(tmp, "wb") as f:        # file handle: savez must not append .npz
        np.savez(f, manifest=np.asarray(json.dumps(manifest)), **arrays)
    os.replace(tmp, path)


def restore_checkpoint_sfm(path: str, device=None) -> Tuple[object, dict, dict, int]:
    """Returns (params, cam_info, pts_info, it), the parameters as
    float32 tensors on ``device`` (``cuda`` unless the caller passes
    another). If the checkpoint carries a phase optimizer state, it is
    loaded into ``sfm/optstate`` and armed for one-shot adoption."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic[:2] == b"PK":
        return _restore_npz(path, device)
    return _restore_legacy_pickle(path, device)


def _to_device(entries, device):
    return [(spec, torch.tensor(np.array(leaf), device=device))
            for spec, leaf in entries]


def _restore_npz(path, device):
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        specs = [[(kind, k) for kind, k in spec]
                 for spec in manifest["param_specs"]]
        params = _tree_from_paths(_to_device(
            [(spec, z[f"param_{i}"]) for i, spec in enumerate(specs)], device))
        cam_info = {
            "pose_para": np.asarray(z["pose_para"]),
            "cam_id": [int(c) for c in z["cam_id"]],
            "idx2d_to_3ds": [np.asarray(z[f"idx2d_{k}"])
                             for k in range(manifest["n_cams"])],
        }
        ptr = np.asarray(z["track_ptr"])
        data = np.asarray(z["track_data"])
        tracks = [[(int(a), int(b)) for a, b in data[ptr[i]:ptr[i + 1]]]
                  for i in range(len(ptr) - 1)]
        pts_info = {"xyzs": np.asarray(z["xyzs"]), "feat_tracks": tracks}
        if manifest.get("optim"):
            from ..sfm import optstate
            o = manifest["optim"]
            optstate.load(o["label"], [np.asarray(z[f"optim_{i}"])
                                       for i in range(o["n_leaves"])])
    return params, cam_info, pts_info, manifest["it"]


def _restore_legacy_pickle(path, device):
    """Version 2 (pickle, numpy leaves with their tree paths). Kept only
    so that older runs stay resumable; ``pickle.load`` executes code
    embedded in the file, so never point this at an untrusted file.
    Version 1 stored a pickled JAX treedef and raises."""
    import pickle
    with open(path, "rb") as f:
        payload = pickle.load(f)
    version = payload.get("version", 1)
    if version < 2:
        raise ValueError(
            f"{path}: a version-1 checkpoint stores a pickled JAX treedef, "
            "which only the JAX package (level_s2fm_tpu) can read; restore "
            "it there and save it again (version 3)")
    params = _tree_from_paths(_to_device(payload["param_paths"], device))
    return params, payload["cam_info"], payload["pts_info"], payload["it"]
