"""Human segmentation (Maron et al. 2017, per-face labels): the dataset and
the driver, counterparts of experiments/human_segmentation_original/."""
