"""Mesh IO: .off / .obj / .ply (ascii, binary little- and big-endian)
readers and writers; the counterpart of diffusionnet_tpu/geometry/io.py.

Replaces the reference's external readers (`pp3d.read_mesh` used by every dataset,
e.g. shrec11_dataset.py:72, and `plyfile` for the point-cloud split,
faust_with_robust_test_dataset.py:107-115). Pure numpy.
"""

from __future__ import annotations

import numpy as np


def read_mesh(path: str):
    """Returns (verts (V,3) float64, faces (F,3) int64). faces has 0 rows for a
    pure point cloud file."""
    lower = path.lower()
    if lower.endswith(".off"):
        return read_off(path)
    if lower.endswith(".obj"):
        return read_obj(path)
    if lower.endswith(".ply"):
        verts, faces, _ = read_ply(path)
        return verts, faces
    raise ValueError(f"unsupported mesh format: {path}")


# recognized OFF header keywords (longest first so CNOFF wins over NOFF/OFF);
# C = per-vertex colors, N = per-vertex normals — trailing vertex columns the
# reader skips (real SHREC/NIST archives contain such variants)
_OFF_KEYWORDS = ("CNOFF", "NCOFF", "COFF", "NOFF", "OFF")


def read_off(path: str):
    with open(path, "rb") as f:
        data = f.read().decode("utf-8", errors="replace")
    try:
        verts, faces, nv = _parse_off(data)
    except (IndexError, ValueError) as e:
        raise ValueError(f"malformed OFF file '{path}': {e}") from None
    if faces.size and (faces.min() < 0 or faces.max() >= nv):
        raise ValueError(f"malformed OFF file '{path}': face index out of "
                         f"range [0, {nv}) — got {faces.min()}..{faces.max()}")
    return verts, faces


def _parse_off(data: str):
    lines = [ln.split() for ln in data.splitlines()]
    lines = [t for t in lines if t and not t[0].startswith("#")]
    if not lines:
        raise ValueError("empty file")
    head = lines[0]
    kw = next((k for k in _OFF_KEYWORDS if head[0].startswith(k)), None)
    li = 0
    if kw is not None:
        rest = head[0][len(kw):]
        if rest:                      # glued 'OFF492 980 0'
            lines[0] = [rest] + head[1:]
        elif len(head) > 1:           # 'OFF 492 980 0' on one line
            lines[0] = head[1:]
        else:
            li = 1                    # counts on the next line
    counts = lines[li]
    nv, nf = int(counts[0]), int(counts[1])
    li += 1                           # counts[2] = edge count (ignored)
    # a reflowed file may glue data onto the counts line ('3 1 0 0 0 0' =
    # counts + first vertex): keep tokens past 'nv nf ne' as a body row
    extra = counts[3:]
    body = ([extra] if extra else []) + lines[li:]

    plain = kw in (None, "OFF")
    # line-aligned layout: one vertex per line (COFF/NOFF/CNOFF rows carry
    # colors/normals in trailing columns — only the leading x y z is read).
    # A plain-OFF vertex line must be EXACTLY 3 tokens: a 6-float line would
    # mean the file was whitespace-reflowed (two vertices on one line), which
    # the token-stream fallback below handles.
    aligned = (len(body) >= nv + nf
               and all(len(t) >= 3 for t in body[:nv])
               and (not plain or all(len(t) == 3 for t in body[:nv])))
    if aligned:
        verts = np.array([t[:3] for t in body[:nv]], dtype=np.float64)
        verts = verts.reshape(nv, 3)
        ft = body[nv:nv + nf]
        if nf and all(len(t) == 4 for t in ft):
            # uniform '3 i j k' faces (the common case): one vectorized parse
            # instead of ~4F interpreter-loop int() calls — minutes saved at
            # the repo's 1M-vertex scale
            quad = np.array(ft, dtype=np.int64)
            if (quad[:, 0] != 3).any():
                raise ValueError("non-triangular face")
            faces = quad[:, 1:]
        else:
            # general path: tolerates per-face color extensions
            # ('3 i j k r g b') by taking the first cnt indices per FACE LINE
            faces = np.zeros((nf, 3), dtype=np.int64)
            for i, toks in enumerate(ft):
                cnt = int(toks[0])
                if cnt != 3:
                    raise ValueError("non-triangular face")
                faces[i] = [int(toks[1]), int(toks[2]), int(toks[3])]
        return verts, faces, nv
    if not plain:
        raise ValueError(f"{kw} vertex rows must be one per line "
                         f"(found {len(body)} data lines for {nv} vertices "
                         f"+ {nf} faces)")
    # token-stream fallback: whitespace-reflowed plain OFF (vertices spanning
    # lines unevenly). Faces parse as variable-length records — per-face
    # colors are indistinguishable from indices here, so they are rejected by
    # the index-range check in read_off rather than silently misparsed.
    tokens = [x for t in body for x in t]
    verts = np.array(tokens[:nv * 3], dtype=np.float64).reshape(nv, 3)
    pos = nv * 3
    faces = np.zeros((nf, 3), dtype=np.int64)
    for i in range(nf):
        cnt = int(tokens[pos])
        if cnt != 3:
            raise ValueError("non-triangular face")
        faces[i] = [int(tokens[pos + 1]), int(tokens[pos + 2]),
                    int(tokens[pos + 3])]
        pos += 1 + cnt
    if pos != len(tokens):
        raise ValueError(f"{len(tokens) - pos} trailing tokens after the "
                         "last face record")
    return verts, faces, nv


def read_obj(path: str):
    verts, faces = [], []
    with open(path, "r") as f:
        for ln, line in enumerate(f, 1):
            try:
                if line.startswith("v "):
                    parts = line.split()
                    verts.append([float(parts[1]), float(parts[2]),
                                  float(parts[3])])
                elif line.startswith("f "):
                    parts = line.split()[1:]
                    idx = [int(p.split("/")[0]) - 1 for p in parts]
                    for j in range(1, len(idx) - 1):  # fan-triangulate
                        faces.append([idx[0], idx[j], idx[j + 1]])
            except (IndexError, ValueError) as e:
                raise ValueError(
                    f"malformed OBJ file '{path}' at line {ln}: {e}") from None
    verts_np = np.asarray(verts, dtype=np.float64)
    faces_np = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    if faces_np.size and (faces_np.min() < 0
                          or faces_np.max() >= len(verts_np)):
        raise ValueError(f"malformed OBJ file '{path}': face index out of "
                         f"range [0, {len(verts_np)})")
    return verts_np, faces_np


_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str):
    """Returns (verts, faces, props) with props a dict of extra per-vertex arrays
    (e.g. normals nx/ny/nz, used by the sampling-invariance point-cloud split)."""
    with open(path, "rb") as f:
        raw = f.read()

    marker = raw.find(b"end_header")
    if marker < 0 or not raw.startswith(b"ply"):
        raise ValueError(f"malformed PLY file '{path}': missing "
                         "ply magic / end_header")
    # the header line terminator may be \n or \r\n (Windows-authored files)
    nl = raw.find(b"\n", marker)
    header_end = (nl + 1) if nl >= 0 else len(raw)
    header = raw[:header_end].decode("ascii", errors="replace").splitlines()
    header = [ln.strip() for ln in header]  # strips trailing \r too
    body = raw[header_end:]

    fmt = None
    elements = []  # list of (name, count, [(type, prop_name) or ('list', ct, it, name)])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))

    verts = np.zeros((0, 3))
    faces = np.zeros((0, 3), dtype=np.int64)
    props: dict[str, np.ndarray] = {}

    if fmt == "ascii":
        tokens = body.decode("ascii").split()
        pos = 0
        for name, count, plist in elements:
            if all(p[0] != "list" for p in plist):
                width = len(plist)
                vals = np.array(tokens[pos:pos + count * width],
                                dtype=np.float64).reshape(count, width)
                pos += count * width
                cols = {p[1]: vals[:, i] for i, p in enumerate(plist)}
                if name == "vertex":
                    verts = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
                    props.update({k: v for k, v in cols.items()
                                  if k not in ("x", "y", "z")})
            else:
                rows = []
                for _ in range(count):
                    cnt = int(tokens[pos]); pos += 1
                    poly = [int(tokens[pos + j]) for j in range(cnt)]
                    pos += cnt
                    for j in range(1, cnt - 1):  # fan-triangulate polygons
                        rows.append([poly[0], poly[j], poly[j + 1]])
                if name == "face" and rows:
                    faces = np.asarray(rows, dtype=np.int64)
    elif fmt in ("binary_little_endian", "binary_big_endian"):
        en = "<" if fmt == "binary_little_endian" else ">"
        offset = 0
        for name, count, plist in elements:
            if all(p[0] != "list" for p in plist):
                dt = np.dtype([(p[1], en + _PLY_TYPES[p[0]]) for p in plist])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
                offset += dt.itemsize * count
                if name == "vertex":
                    verts = np.stack([arr["x"], arr["y"], arr["z"]],
                                     axis=1).astype(np.float64)
                    props.update({p[1]: np.asarray(arr[p[1]]) for p in plist
                                  if p[1] not in ("x", "y", "z")})
            else:
                # assume uniform triangle lists (common case)
                _, ct, it, _pname = plist[0]
                ct_dt = np.dtype(en + _PLY_TYPES[ct])
                it_dt = np.dtype(en + _PLY_TYPES[it])
                rows = []
                for _ in range(count):
                    cnt = int(np.frombuffer(body, dtype=ct_dt, count=1,
                                            offset=offset)[0])
                    offset += ct_dt.itemsize
                    idx = np.frombuffer(body, dtype=it_dt, count=cnt, offset=offset)
                    offset += it_dt.itemsize * cnt
                    if name == "face":
                        poly = idx.astype(np.int64)
                        for j in range(1, cnt - 1):  # fan-triangulate
                            rows.append(np.array([poly[0], poly[j],
                                                  poly[j + 1]]))
                if name == "face" and rows:
                    faces = np.stack(rows)
    else:
        raise ValueError(f"unsupported ply format: {fmt}")

    return verts, faces, props


def write_off(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        f.write("OFF\n")
        f.write(f"{len(verts)} {len(faces)} 0\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:  # obj is 1-based
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray | None = None,
              normals: np.ndarray | None = None):
    """ASCII ply writer; optional per-vertex normals (nx/ny/nz properties, the
    layout the sampling-invariance point-cloud split reads back)."""
    nf = 0 if faces is None else len(faces)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if normals is not None:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        f.write(f"element face {nf}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for i, v in enumerate(verts):
            row = f"{v[0]} {v[1]} {v[2]}"
            if normals is not None:
                n = normals[i]
                row += f" {n[0]} {n[1]} {n[2]}"
            f.write(row + "\n")
        for face in (faces if faces is not None else ()):
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def write_mesh(path: str, verts: np.ndarray, faces: np.ndarray):
    lower = path.lower()
    if lower.endswith(".off"):
        return write_off(path, verts, faces)
    if lower.endswith(".obj"):
        return write_obj(path, verts, faces)
    if lower.endswith(".ply"):
        return write_ply(path, verts, faces)
    raise ValueError(f"unsupported mesh format: {path}")
