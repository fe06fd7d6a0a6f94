"""Supervised functional-map correspondence on FAUST and SCAPE: the pair
dataset and the driver, counterparts of
experiments/functional_correspondence/."""
