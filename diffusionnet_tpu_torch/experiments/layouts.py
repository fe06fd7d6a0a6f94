"""Each experiment suite's on-disk dataset layout, written from given
meshes: the files that the suite's prepare_data.py would lay out, with
synthetic geometry and seeded labels, so a driver runs end to end (both
packages' drivers read the same layout) without the real datasets.

Each function takes meshes as (verts, faces) pairs and returns the root
it wrote under.

  human_segmentation   reference human_segmentation_original_dataset.py
  rna                  reference rna_mesh_dataset.py
  shrec11_simplified   reference shrec11_dataset.py (MeshCNN layout)
  shrec11_original     reference shrec11_dataset.py (categories.txt)
  sampling_invariance  reference faust_with_robust_test_dataset.py
  fmaps                reference faust_scape_dataset.py
"""

from __future__ import annotations

import itertools
import os

import numpy as np

from ..geometry.io import write_obj, write_off, write_ply
from .classification_shrec11.shrec11_dataset import SIMPLIFIED_CLASS_NAMES
from .human_segmentation_original.human_segmentation_original_dataset import (
    MIT_POSES)
from .sampling_invariance.faust_with_robust_test_dataset import (
    MUTATIONS, registration_path)

# the 18 test meshes of the human segmentation walk (shrec 1-20 without 16
# and 18; 12 under its fixed name)
SHREC_TEST = [i for i in range(1, 21) if i not in (16, 18)]


def _labels(path, n, low, high, seed):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, np.random.RandomState(seed).randint(low, high, size=n),
               fmt="%d")


def human_segmentation(root, train, test, seed=0):
    """train meshes go to adobe, faust, scape and the MIT poses in turn
    (one mesh each in faust, scape and each pose, whose label file is
    shared); the test meshes are written cyclically to the 18 shrec names.
    Face labels 1..8."""
    m = os.path.join(root, "meshes")
    s = os.path.join(root, "segs")
    dirs = [("adobe", None), ("faust", "faust_corrected.txt"),
            ("scape", "scape_corrected.txt")] + [
        (os.path.join("MIT_animation", f"meshes_{p}", "meshes"),
         f"mit_{p}_corrected.txt") for p in MIT_POSES]
    for sub, _ in dirs:
        os.makedirs(os.path.join(m, "train", sub), exist_ok=True)
    os.makedirs(os.path.join(m, "test", "shrec"), exist_ok=True)
    if len(train) > len(dirs):
        raise ValueError(f"at most {len(dirs)} train meshes (one a folder)")
    for i, (v, f) in enumerate(train):
        sub, label_name = dirs[i]
        name = f"mesh_{i}.off"
        write_off(os.path.join(m, "train", sub, name), v, f)
        if label_name is None:
            lbl = os.path.join(s, "train", sub, name[:-4] + ".txt")
        elif sub.startswith("MIT"):
            lbl = os.path.join(s, "train", "mit", label_name)
        else:
            lbl = os.path.join(s, "train", sub, label_name)
        _labels(lbl, len(f), 1, 9, seed + i)
    for j, (i, (v, f)) in enumerate(zip(SHREC_TEST, itertools.cycle(test))):
        name = "12_fix_orientation.off" if i == 12 else f"{i}.off"
        write_off(os.path.join(m, "test", "shrec", name), v, f)
        _labels(os.path.join(s, "test", "shrec", f"shrec_{i}_full.txt"),
                len(f), 1, 9, seed + 100 + j % len(test))
    return root


def rna(root, meshes, n_train, seed=0):
    """off/rna_<i>.off with vertex labels in {-1, .., 258} (the loader
    shifts them by +1); the first n_train in train.txt, the rest in
    test.txt."""
    os.makedirs(os.path.join(root, "off"), exist_ok=True)
    names = [f"rna_{i}.off" for i in range(len(meshes))]
    for i, (name, (v, f)) in enumerate(zip(names, meshes)):
        write_off(os.path.join(root, "off", name), v, f)
        _labels(os.path.join(root, "labels", name[:-4] + ".txt"), len(v),
                -1, 259, seed + i)
    with open(os.path.join(root, "train.txt"), "w") as fh:
        fh.write("\n".join(names[:n_train]) + "\n")
    with open(os.path.join(root, "test.txt"), "w") as fh:
        fh.write("\n".join(names[n_train:]) + "\n")
    return root


def shrec11_simplified(root, mesh, n_train=1, n_test=1):
    """raw/shrec_16/<class>/{train,test}/T<i>.obj: n_train and n_test
    meshes in each of the 30 classes' two folders; mesh(c, t, i) gives each
    one (class index, 'train' or 'test', index)."""
    for c, cname in enumerate(SIMPLIFIED_CLASS_NAMES):
        for t, n in (("train", n_train), ("test", n_test)):
            d = os.path.join(root, "raw", "shrec_16", cname, t)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                write_obj(os.path.join(d, f"T{i}.obj"), *mesh(c, t, i))
    return root


def shrec11_original(root, mesh):
    """categories.txt (two header lines, then per class a blank line, a
    'name - 20' line and 20 mesh ids) and raw/T<id>.off, mesh(id) giving
    each of the 600 meshes."""
    os.makedirs(os.path.join(root, "raw"), exist_ok=True)
    lines = ["SHREC 2011 categories", ""]
    for c in range(30):
        lines += ["", f"class{c:02d} - 20"]
        lines += [str(20 * c + i) for i in range(20)]
    with open(os.path.join(root, "categories.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    for k in range(600):
        write_off(os.path.join(root, "raw", f"T{k}.off"), *mesh(k))
    return root


def sampling_invariance(root, registrations, mutations):
    """registrations: the FAUST registrations tr_reg_000.. (train, then the
    held-out ones, whose 'orig' split reads them); mutations: {method:
    [(verts, faces or normals, labels), ...]} for the held-out shapes in
    order, the five methods past 'orig' ('cloud' takes normals in place of
    faces)."""
    n_reg = len(registrations)
    for i, (v, f) in enumerate(registrations):
        path = registration_path(root, i)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_ply(path, v, f)
    n_held = len(next(iter(mutations.values())))
    for method in MUTATIONS[1:]:
        d = os.path.join(root, "test", "data", method)
        os.makedirs(d, exist_ok=True)
        for j, (v, f_or_n, labels) in enumerate(mutations[method]):
            name = os.path.join(d, f"tr_reg_{method}_{n_reg - n_held + j:03d}")
            if method == "cloud":
                write_ply(name + ".ply", v, None, normals=f_or_n)
            else:
                write_ply(name + ".ply", v, f_or_n)
            np.savetxt(name + ".txt", labels, fmt="%d")
    return root


def fmaps(root, meshes, name="faust", n_vts=40, seed=0):
    """<name>/off_2/tr_reg_<i>.off and <name>/corres/tr_reg_<i>.vts, each
    .vts n_vts distinct 1-based vertex ids drawn with seed + i."""
    for i, (v, f) in enumerate(meshes):
        stem = f"tr_reg_{i:03d}"
        os.makedirs(os.path.join(root, name, "off_2"), exist_ok=True)
        os.makedirs(os.path.join(root, name, "corres"), exist_ok=True)
        write_off(os.path.join(root, name, "off_2", stem + ".off"), v, f)
        vts = np.random.RandomState(seed + i).permutation(len(v))[:n_vts] + 1
        np.savetxt(os.path.join(root, name, "corres", stem + ".vts"), vts,
                   fmt="%d")
    return root
