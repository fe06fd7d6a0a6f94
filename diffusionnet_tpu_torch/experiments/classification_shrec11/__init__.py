"""SHREC11 30-class mesh classification: the datasets and the driver,
counterparts of experiments/classification_shrec11/."""
