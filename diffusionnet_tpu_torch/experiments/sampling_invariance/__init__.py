"""Sampling invariance on FAUST with the discretization-robust test splits:
the dataset and the driver, counterparts of experiments/sampling_invariance/."""
