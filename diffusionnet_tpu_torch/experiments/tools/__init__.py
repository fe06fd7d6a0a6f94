"""Tools of the experiment drivers: the reference-checkpoint converter."""
