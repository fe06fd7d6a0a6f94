"""FAUST/SCAPE correspondence pair dataset: the counterpart of
experiments/functional_correspondence/faust_scape_dataset.py (reference
experiments/functional_correspondence/faust_scape_dataset.py).

Loads every shape of the chosen dataset (off_2 meshes and the 1-based
template correspondences in corres/*.vts, each .vts path taken from its
mesh's name), normalizes positions by area and precomputes the operators.
Train pairs are the permutations of the first 80 (faust) / 51 (scape)
shapes, test pairs the combinations of the next 20 (reference :35-39). The
ground-truth functional map C_gt is the least-squares alignment of the
paired eigenvector samples (reference :186-191).
"""

from __future__ import annotations

import os
from itertools import combinations, permutations

import numpy as np

from ...geometry import get_operators, read_mesh
from ...models.fmaps import gt_fmap
from ...utils import normalize_positions_np


class FaustScapeDataset:
    """n_train, n_test: the reference splits by default (80/51 train, 20
    held-out test). device: where the operators' eigensolves run. timings:
    an optional dict that receives the precompute's wall seconds per
    stage (none for shapes read from the operator cache)."""

    def __init__(self, root_dir, name="faust", train=True, k_eig=128,
                 n_fmap=30, op_cache_dir=None, n_train=None, n_test=20,
                 device="cuda", timings=None):
        self.train = train
        self.k_eig = k_eig
        self.n_fmap = n_fmap
        self.name = name
        self.verts_list, self.faces_list = [], []
        self.vts_list, self.names_list, self.ops_list = [], [], []
        self._fmap_cache: dict = {}

        if n_train is None:
            n_train = {"faust": 80, "scape": 51}[name]
        if train:
            self.combinations = list(permutations(range(n_train), 2))
        else:
            self.combinations = list(
                combinations(range(n_train, n_train + n_test), 2))

        mesh_dirpath = os.path.join(root_dir, name, "off_2")
        if not os.path.isdir(mesh_dirpath):
            raise FileNotFoundError(
                f"{name} meshes not found at {mesh_dirpath}; see the README"
                " of experiments/functional_correspondence for download"
                " instructions")
        vts_dirpath = os.path.join(root_dir, name, "corres")
        # each .vts path FROM its mesh's name: two independently sorted
        # listings misalign every pair after a stray or missing file
        mesh_files = sorted(
            os.path.join(mesh_dirpath, f) for f in os.listdir(mesh_dirpath)
            if f.lower().endswith((".off", ".obj", ".ply")))
        vts_files = [os.path.join(vts_dirpath,
                                  os.path.splitext(os.path.basename(m))[0]
                                  + ".vts")
                     for m in mesh_files]
        missing = [v for v in vts_files if not os.path.exists(v)]
        if missing:
            raise FileNotFoundError(
                f"correspondence files missing for {len(missing)} meshes, "
                f"e.g. {missing[0]}")

        print(f"loading {len(mesh_files)} meshes")
        for mesh_path, vts_path in zip(mesh_files, vts_files):
            verts, faces = read_mesh(mesh_path)
            vts = np.loadtxt(vts_path).astype(int) - 1  # 1-based -> 0-based
            verts = normalize_positions_np(verts, faces=faces,
                                           scale_method="area")
            self.verts_list.append(verts.astype(np.float32))
            self.faces_list.append(faces)
            self.vts_list.append(vts)
            self.names_list.append(os.path.basename(mesh_path).split(".")[0])
            self.ops_list.append(get_operators(
                verts, faces, k_eig=k_eig, op_cache_dir=op_cache_dir,
                device=device, timings=timings))

    def __len__(self):
        return len(self.combinations)

    def gt_fmap(self, idx1: int, idx2: int) -> np.ndarray:
        """C_gt of a pair (n_fmap, n_fmap), solved once per pair."""
        if (idx1, idx2) not in self._fmap_cache:
            self._fmap_cache[(idx1, idx2)] = gt_fmap(
                self.ops_list[idx1], self.ops_list[idx2], self.n_fmap,
                self.vts_list[idx1], self.vts_list[idx2])
        return self._fmap_cache[(idx1, idx2)]

    def __getitem__(self, idx):
        idx1, idx2 = self.combinations[idx]
        return idx1, idx2, self.gt_fmap(idx1, idx2)
