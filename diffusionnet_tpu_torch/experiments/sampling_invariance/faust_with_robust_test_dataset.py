"""FAUST with discretization-robustness test splits: the counterpart of
experiments/sampling_invariance/faust_with_robust_test_dataset.py (reference
experiments/sampling_invariance/faust_with_robust_test_dataset.py).

Train: the FAUST template registrations 0..n_train-1 (labels = identity
vertex indices). Test: meshes n_train..n_train+n_test-1 in six mutations
{orig, iso, qes, mc, dense, cloud} (the remeshings and the point-cloud
sampling of the discretization-robust correspondence benchmark). The cloud
split reads per-vertex normals from the ply (nx, ny, nz) and passes them to
the operator precompute (reference :107-115,:146). Positions are centred on
their bounding box and scaled to unit radius.
"""

from __future__ import annotations

import os

import numpy as np

from ...data import SurfaceDataset
from ...geometry import read_mesh, read_ply
from ...utils import normalize_positions_np

MUTATIONS = ["orig", "iso", "qes", "mc", "dense", "cloud"]


def registration_path(root_dir, i: int) -> str:
    return os.path.join(root_dir, "train", "MPI-FAUST", "training",
                        "registrations", f"tr_reg_{i:03d}.ply")


class FaustWithRobustTestDataset(SurfaceDataset):
    """n_train, n_test: the reference split by default (meshes 0-79 train,
    80-99 per-mutation test, reference :44,:85). mut_list: each shape's
    mutation (None for training shapes). device: where the operators'
    eigensolves run. timings: an optional dict that receives the
    precompute's wall seconds per stage."""

    def __init__(self, root_dir, train: bool, k_eig: int = 128,
                 op_cache_dir=None, n_train: int = 80, n_test: int = 20,
                 device="cuda", timings=None):
        super().__init__(labels_kind="vertex")
        self.n_class = 6890
        self.mut_list = []
        normals_list = []
        if not os.path.isdir(root_dir):
            raise FileNotFoundError(
                f"FAUST robust-benchmark data not found at {root_dir}; see"
                " the README of experiments/sampling_invariance for download"
                " instructions")
        test_dirpath = os.path.join(root_dir, "test", "data")
        if train:
            for i in range(n_train):
                verts, faces = read_mesh(registration_path(root_dir, i))
                verts = normalize_positions_np(verts, method="bbox")
                self.add(verts, faces, np.arange(verts.shape[0]))
                self.mut_list.append(None)
                normals_list.append(None)
            print(f"loaded {len(self)} train meshes")
        else:
            for method in MUTATIONS:
                for i in range(n_train, n_train + n_test):
                    normals = None
                    stem = os.path.join(test_dirpath, method,
                                        f"tr_reg_{method}_{i:03d}")
                    if method == "orig":
                        verts, faces = read_mesh(registration_path(root_dir,
                                                                   i))
                        labels = np.arange(verts.shape[0])
                    elif method == "cloud":
                        verts, _, props = read_ply(stem + ".ply")
                        faces = np.zeros((0, 3), np.int64)
                        normals = np.stack([props["nx"], props["ny"],
                                            props["nz"]], axis=-1)
                        labels = np.loadtxt(stem + ".txt", dtype=np.int64)
                    else:
                        verts, faces = read_mesh(stem + ".ply")
                        labels = np.loadtxt(stem + ".txt", dtype=np.int64)
                    verts = normalize_positions_np(verts, method="bbox")
                    self.add(verts, faces, labels)
                    self.mut_list.append(method)
                    normals_list.append(normals)
            print(f"loaded {len(self)} test meshes/clouds")
        self.precompute(k_eig, op_cache_dir, normals_list=normals_list,
                        device=device, timings=timings)
