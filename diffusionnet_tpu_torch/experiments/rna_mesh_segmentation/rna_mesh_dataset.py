"""RNA surface segmentation dataset (Poulenard et al., 3DV 2019): per-VERTEX
labels, 260 classes. The counterpart of
experiments/rna_mesh_segmentation/rna_mesh_dataset.py, as the reference
(experiments/rna_mesh_segmentation/rna_mesh_dataset.py): train and test
from the txt file lists, labels shifted by +1 so the -1 class becomes 0.
"""

from __future__ import annotations

import os

import numpy as np

from ...data import SurfaceDataset
from ...geometry import read_mesh
from ...utils import normalize_positions_np


class RNAMeshDataset(SurfaceDataset):
    """device: where the operators' eigensolves run. timings: an optional
    dict that receives the precompute's wall seconds per stage."""

    def __init__(self, root_dir, train: bool, k_eig: int,
                 op_cache_dir=None, device="cuda", timings=None):
        super().__init__(labels_kind="vertex")
        self.n_class = 260  # (includes -1, shifted to 0)
        split_file = os.path.join(root_dir,
                                  "train.txt" if train else "test.txt")
        if not os.path.exists(split_file):
            raise FileNotFoundError(
                f"RNA dataset split list not found at {split_file}; see the"
                " README of experiments/rna_mesh_segmentation for download"
                " instructions")
        with open(split_file) as f:
            this_files = [line.rstrip() for line in f]
        print(f"loading {len(this_files)} files: {this_files}")
        off_path = os.path.join(root_dir, "off")
        label_path = os.path.join(root_dir, "labels")
        for f in this_files:
            verts, faces = read_mesh(os.path.join(off_path, f))
            labels = np.loadtxt(
                os.path.join(label_path, f[:-4] + ".txt")).astype(int) + 1
            self.add(normalize_positions_np(verts), faces, labels)
        self.precompute(k_eig, op_cache_dir, device=device, timings=timings)
