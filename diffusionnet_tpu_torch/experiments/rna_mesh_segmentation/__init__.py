"""RNA surface segmentation (Poulenard et al., 3DV 2019, per-vertex labels,
260 classes): the dataset and the driver, counterparts of
experiments/rna_mesh_segmentation/."""
