"""Human segmentation dataset of Maron et al. (original, per-FACE labels):
the counterpart of
experiments/human_segmentation_original/human_segmentation_original_dataset.py,
with the reference's file-layout walk: train = adobe + faust + scape + the 8 MIT animation poses; test = shrec
meshes 1-20 without 16 and 18, with the 12_fix_orientation file name; labels
are 1-based ints in txt files (shifted to 0-based here).
"""

from __future__ import annotations

import os

import numpy as np

from ...data import SurfaceDataset
from ...geometry import read_mesh
from ...utils import normalize_positions_np

MIT_POSES = ['bouncing', 'handstand', 'march1', 'squat1',
             'crane', 'jumping', 'march2', 'squat2']


class HumanSegOrigDataset(SurfaceDataset):
    """device: where the operators' eigensolves run. timings: an optional
    dict that receives the precompute's wall seconds per stage (none when
    every mesh came from the operator cache)."""

    def __init__(self, root_dir, train: bool, k_eig: int = 128,
                 op_cache_dir=None, device="cuda", timings=None):
        super().__init__(labels_kind="face")
        self.n_class = 8
        if not os.path.isdir(root_dir):
            raise FileNotFoundError(
                f"human segmentation data not found at {root_dir}; see the"
                " README of experiments/human_segmentation_original for"
                " download instructions")
        mesh_files, label_files = [], []
        if train:
            for sub, label_name in [("adobe", None),
                                    ("faust", "faust_corrected.txt"),
                                    ("scape", "scape_corrected.txt")]:
                mesh_dirpath = os.path.join(root_dir, "meshes", "train", sub)
                label_dirpath = os.path.join(root_dir, "segs", "train", sub)
                for fname in sorted(os.listdir(mesh_dirpath)):
                    mesh_files.append(os.path.join(mesh_dirpath, fname))
                    label_files.append(os.path.join(
                        label_dirpath,
                        label_name if label_name else fname[:-4] + ".txt"))
            label_dirpath = os.path.join(root_dir, "segs", "train", "mit")
            for pose in MIT_POSES:
                mesh_dirpath = os.path.join(root_dir, "meshes", "train",
                                            "MIT_animation", f"meshes_{pose}",
                                            "meshes")
                for fname in sorted(os.listdir(mesh_dirpath)):
                    mesh_files.append(os.path.join(mesh_dirpath, fname))
                    label_files.append(os.path.join(
                        label_dirpath, f"mit_{pose}_corrected.txt"))
        else:
            mesh_dirpath = os.path.join(root_dir, "meshes", "test", "shrec")
            label_dirpath = os.path.join(root_dir, "segs", "test", "shrec")
            for i_shrec in range(1, 21):
                if i_shrec in (16, 18):
                    continue
                mesh_fname = ("12_fix_orientation.off" if i_shrec == 12
                              else f"{i_shrec}.off")
                mesh_files.append(os.path.join(mesh_dirpath, mesh_fname))
                label_files.append(os.path.join(label_dirpath,
                                                f"shrec_{i_shrec}_full.txt"))

        print(f"loading {len(mesh_files)} meshes")
        for mesh_path, label_path in zip(mesh_files, label_files):
            print("loading mesh " + mesh_path)
            verts, faces = read_mesh(mesh_path)
            labels = np.loadtxt(label_path).astype(int) - 1
            self.add(normalize_positions_np(verts), faces, labels)
        self.precompute(k_eig, op_cache_dir, device=device, timings=timings)
