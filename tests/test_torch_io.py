"""Mesh IO in the port against the JAX package's readers on the same files:
OFF variants (header forms, colour and normal columns, a reflowed file),
OBJ (slashes, a quad), PLY in ASCII, binary little- and big-endian with
normals, and the writers' round trips."""

import numpy as np
import pytest

from diffusionnet_tpu.geometry import io as jio
from diffusionnet_tpu_torch.geometry import io as tio
from tests.meshgen import icosphere
from tests.torch_threads import one_torch_thread  # noqa: F401


def _both(path, reader):
    t = getattr(tio, reader)(str(path))
    j = getattr(jio, reader)(str(path))
    assert len(t) == len(j)
    for a, b in zip(t, j):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                assert a[k].dtype == b[k].dtype
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    return t


OFF_FILES = {
    "plain": "OFF\n4 2 0\n0 0 0\n1 0 0\n0 1 0\n0 0 1\n3 0 1 2\n3 0 2 3\n",
    "one_line": "OFF 4 2 0\n0 0 0\n1 0 0\n0 1 0\n0 0 1\n3 0 1 2\n3 0 2 3\n",
    "glued": "OFF4 2 0\n0 0 0\n1 0 0\n0 1 0\n0 0 1\n3 0 1 2\n3 0 2 3\n",
    "comments": "# c\nOFF\n# c\n4 2 0\n0 0 0\n1 0 0\n0 1 0\n0 0 1\n"
                "3 0 1 2\n3 0 2 3\n",
    "coff": "COFF\n4 2 0\n0 0 0 255 0 0 255\n1 0 0 0 255 0 255\n"
            "0 1 0 0 0 255 255\n0 0 1 9 9 9 255\n3 0 1 2\n3 0 2 3\n",
    "noff": "NOFF\n4 2 0\n0 0 0 0 0 1\n1 0 0 0 0 1\n0 1 0 0 0 1\n"
            "0 0 1 1 0 0\n3 0 1 2 7 7 7\n3 0 2 3\n",
    "reflowed": "OFF\n4 2 0\n0 0 0 1 0 0\n0 1 0\n0 0 1 3 0 1 2 3\n0 2 3\n",
}


@pytest.mark.parametrize("variant", sorted(OFF_FILES))
def test_off_variants_match_jax(tmp_path, variant):
    p = tmp_path / f"{variant}.off"
    p.write_text(OFF_FILES[variant])
    v, f = _both(p, "read_off")
    assert v.shape == (4, 3) and f.shape == (2, 3)
    _both(p, "read_mesh")


def test_off_bad_index_raises_like_jax(tmp_path):
    p = tmp_path / "bad.off"
    p.write_text("OFF\n3 1 0\n0 0 0\n1 0 0\n0 1 0\n3 0 1 5\n")
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="out of range"):
            mod.read_off(str(p))


def test_obj_matches_jax(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text("# obj\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\n"
                 "f 1/1/1 2/2/1 3/3/1 4/4/1\nf 1 3 4\n")
    v, f = _both(p, "read_obj")
    assert f.shape == (3, 3)
    _both(p, "read_mesh")


def _binary_ply(path, verts, normals, faces, endian):
    en = "<" if endian == "little" else ">"
    head = (f"ply\r\nformat binary_{endian}_endian 1.0\r\n"
            f"element vertex {len(verts)}\r\n"
            "property float x\r\nproperty float y\r\nproperty float z\r\n"
            "property double nx\r\nproperty double ny\r\nproperty double nz\r\n"
            f"element face {len(faces)}\r\n"
            "property list uchar int vertex_indices\r\nend_header\r\n")
    vdt = np.dtype([(n, en + t) for n, t in
                    (("x", "f4"), ("y", "f4"), ("z", "f4"),
                     ("nx", "f8"), ("ny", "f8"), ("nz", "f8"))])
    rows = np.zeros(len(verts), vdt)
    for i, n in enumerate("xyz"):
        rows[n] = verts[:, i]
        rows["n" + n] = normals[:, i]
    body = rows.tobytes()
    for face in faces:
        body += np.uint8(3).tobytes() + face.astype(en + "i4").tobytes()
    path.write_bytes(head.encode() + body)


@pytest.mark.parametrize("fmt", ["ascii", "little", "big"])
def test_ply_with_normals_matches_jax(tmp_path, fmt):
    """The E5 cloud split's layout: positions and nx/ny/nz; the ASCII file
    from the port's writer, the binary ones built here."""
    v, f = icosphere(1)
    n = v / np.linalg.norm(v, axis=1, keepdims=True)
    p = tmp_path / f"m_{fmt}.ply"
    if fmt == "ascii":
        tio.write_ply(str(p), v, f, normals=n)
    else:
        _binary_ply(p, v, n, f, fmt)
    verts, faces, props = _both(p, "read_ply")
    np.testing.assert_allclose(verts, v, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(faces, f)
    got_n = np.stack([props["nx"], props["ny"], props["nz"]], axis=1)
    np.testing.assert_allclose(got_n, n, rtol=1e-6, atol=1e-7)
    _both(p, "read_mesh")


def test_point_cloud_ply_has_no_faces(tmp_path):
    v, _ = icosphere(1)
    p = tmp_path / "cloud.ply"
    tio.write_ply(str(p), v, None, normals=v)
    verts, faces, props = _both(p, "read_ply")
    assert faces.shape == (0, 3) and verts.shape == v.shape


@pytest.mark.parametrize("ext", ["off", "obj", "ply"])
def test_writers_round_trip_and_match_jax_writers(tmp_path, ext):
    """write_mesh then read_mesh gives the mesh back, and the port's
    writer produces the JAX writer's bytes."""
    v, f = icosphere(2)
    pt, pj = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
    tio.write_mesh(str(pt), v, f)
    jio.write_mesh(str(pj), v, f)
    assert pt.read_bytes() == pj.read_bytes()
    verts, faces = tio.read_mesh(str(pt))
    np.testing.assert_allclose(verts, v, rtol=1e-12)
    np.testing.assert_array_equal(faces, f)
    with pytest.raises(ValueError, match="unsupported"):
        tio.read_mesh(str(tmp_path / "x.stl"))
