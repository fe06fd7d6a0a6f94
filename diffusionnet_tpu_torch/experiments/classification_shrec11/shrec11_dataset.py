"""SHREC11 30-class mesh classification datasets: the counterpart of
experiments/classification_shrec11/shrec11_dataset.py, the reference's data
layout and split (experiments/classification_shrec11/shrec11_dataset.py):
the Original NIST .off variant (categories.txt + raw/T{name}.off) and the
Simplified MeshCNN variant (raw/shrec_16/{class}/{train,test}/*.obj).
Splits are random `split_size` picks per class, drawn anew each run from
numpy's global random state (as the JAX package draws them, so one
np.random.seed gives both packages the same split), with an exclude_dict
that makes a disjoint test set.
"""

from __future__ import annotations

import os

import numpy as np

from ...data import SurfaceDataset
from ...geometry import read_mesh
from ...utils import normalize_positions_np

SIMPLIFIED_CLASS_NAMES = [
    'alien', 'ants', 'armadillo', 'bird1', 'bird2', 'camel', 'cat', 'centaur',
    'dinosaur', 'dino_ske', 'dog1', 'dog2', 'flamingo', 'glasses', 'gorilla',
    'hand', 'horse', 'lamp', 'laptop', 'man', 'myScissor', 'octopus', 'pliers',
    'rabbit', 'santa', 'shark', 'snake', 'spiders', 'two_balls', 'woman']


def _take_split(candidates, split_size, exclude: set):
    """split_size random picks of candidates outside `exclude` (the
    reference's split), drawn from numpy's global random state; None takes
    them all."""
    order = np.random.permutation(len(candidates))
    chosen = []
    for ind in order:
        if split_size is not None and len(chosen) == split_size:
            break
        name = candidates[ind]
        if name in exclude:
            continue
        chosen.append(name)
    if split_size is not None and len(chosen) < split_size:
        raise ValueError(
            "could not find enough entries to generate requested split")
    return chosen


class _Shrec11(SurfaceDataset):
    def _add_class(self, class_idx, class_name, candidates, path_of,
                   split_size, exclude_dict):
        exclude = (exclude_dict or {}).get(class_name, set())
        chosen = _take_split(candidates, split_size, exclude)
        self.entries[class_name] = set(chosen)
        for name in chosen:
            verts, faces = read_mesh(path_of(name))
            self.add(normalize_positions_np(verts), faces, class_idx)
        return chosen


class Shrec11MeshDataset_Simplified(_Shrec11):
    """device: where the operators' eigensolves run. timings: an optional
    dict that receives the precompute's wall seconds per stage."""

    def __init__(self, root_dir, split_size, k_eig, exclude_dict=None,
                 op_cache_dir=None, device="cuda", timings=None):
        super().__init__(labels_kind="global")
        self.entries = {}
        raw_path = os.path.join(root_dir, "raw", "shrec_16")
        if not os.path.isdir(raw_path):
            raise FileNotFoundError(
                f"SHREC11 simplified data not found at {raw_path}; see the"
                " README of experiments/classification_shrec11 for download"
                " instructions")
        for class_idx, class_name in enumerate(SIMPLIFIED_CLASS_NAMES):
            mesh_files = []
            for t in ["test", "train"]:
                d = os.path.join(raw_path, class_name, t)
                for f in sorted(os.listdir(d)):
                    mesh_files.append(os.path.join(d, f))
            chosen = self._add_class(class_idx, class_name, mesh_files,
                                     lambda p: p, split_size, exclude_dict)
            print(class_name + " -- "
                  + " ".join(os.path.basename(p) for p in chosen))
        self.precompute(k_eig, op_cache_dir, device=device, timings=timings)


class Shrec11MeshDataset_Original(_Shrec11):
    """device, timings: as Shrec11MeshDataset_Simplified."""

    def __init__(self, root_dir, split_size, k_eig, exclude_dict=None,
                 op_cache_dir=None, device="cuda", timings=None):
        super().__init__(labels_kind="global")
        self.entries = {}
        self.class_names = []
        with open(os.path.join(root_dir, "categories.txt")) as cat_file:
            cat_file.readline()
            cat_file.readline()
            for i_class in range(30):
                cat_file.readline()
                class_name, _, count = cat_file.readline().strip().split()
                self.class_names.append(class_name)
                mesh_list = [cat_file.readline().strip() for _ in range(20)]
                chosen = self._add_class(
                    i_class, class_name, mesh_list,
                    lambda n: os.path.join(root_dir, "raw", f"T{n}.off"),
                    split_size, exclude_dict)
                print(class_name + " -- " + " ".join(chosen))
        self.precompute(k_eig, op_cache_dir, device=device, timings=timings)
