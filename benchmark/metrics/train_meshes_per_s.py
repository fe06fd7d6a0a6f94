"""train_meshes_per_s: real (unpadded) meshes trained in the window over
the window's wall seconds, the card synchronised at its end; host
clock."""


def read(record):
    w = record["window"]
    return w["meshes"] / w["wall_s"] if "meshes" in w else None
