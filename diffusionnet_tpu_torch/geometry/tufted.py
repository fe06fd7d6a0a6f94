"""Tufted intrinsic Delaunay Laplacian — the literal Sharp & Crane cover.
The counterpart of diffusionnet_tpu/geometry/tufted.py.

Completes the robust-Laplacian story (reference geometry.py:17,317 uses the
`robust_laplacian` C++ package): `point_cloud.py` assembles cotans on the raw
triangle soup, which equals the tufted-cover operator up to a global factor 2
*as long as no intrinsic edge flips are performed*. The robust-laplacian
package, however, also runs INTRINSIC DELAUNAY refinement on the cover — the
step that restores the maximum principle (all-positive edge weights on
Delaunay triangulations) and tames near-degenerate inputs. That step needs the
actual cover connectivity (an edge-manifold gluing of the doubled soup), which
this module builds.

Pipeline (Sharp & Crane, "A Laplacian for Nonmanifold Triangle Meshes",
SGP 2020):
  1. Double every face (front + reversed back copy) and glue the 2m half-edges
     around each undirected soup edge into m edge-manifold pairs. Any perfect
     front/back matching yields a valid cover; we sort both sides by face id
     and shift by one so a consistently-oriented manifold mesh reproduces its
     orientation double cover (two disjoint copies), and a boundary edge folds
     the two copies onto each other.
  2. Mollify intrinsic edge lengths globally (same delta rule as
     point_cloud._intrinsic_mollify) so every cotangent is finite.
  3. Flip non-Delaunay interior edges to convergence (Bobenko & Springborn:
     the intrinsic flip algorithm terminates). Lengths of flipped diagonals
     come from flattening the two incident triangles — connectivity surgery
     is irregular pointer-chasing, so it runs on host at precompute time like
     every other connectivity build in this package; the operators it emits
     feed the device pipeline unchanged.
  4. Assemble the cotan Laplacian + barycentric mass from the FINAL intrinsic
     lengths onto the original vertices and halve (each surface point is
     covered twice).

With `flip=False` the result is exactly `_soup_laplacian`'s (the gluing is
irrelevant until edges flip), which doubles as the structural test that the
cover and its down-mapping are right.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse

from .point_cloud import _intrinsic_mollify


def _build_cover(faces: np.ndarray):
    """Halfedge arrays of the tufted double cover.

    Returns (tail, nxt, twin, length_index) — all (6F,) int64 except
    lengths, plus the (6F,) float64 intrinsic lengths are built by the
    caller (they depend on verts). Halfedge 3*t + c is edge c of cover
    triangle t; triangles 0..F-1 are front copies (i,j,k), F..2F-1 back
    copies (k,j,i). twin[h] = -1 never occurs: the tufted cover is closed
    (boundary edges fold the two copies onto each other)."""
    F = faces.shape[0]
    front = faces
    back = faces[:, ::-1]                      # reversed orientation
    tris = np.concatenate([front, back], axis=0)        # (2F, 3)
    T = 2 * F
    tail = tris[:, [0, 1, 2]].reshape(-1)               # halfedge 3t+c: from
    head = tris[:, [1, 2, 0]].reshape(-1)               #   corner c to c+1
    nxt = (np.arange(T * 3).reshape(T, 3)[:, [1, 2, 0]]).reshape(-1)

    # Group halfedges by undirected edge. Every face containing edge {u,v}
    # contributes exactly one u->v halfedge and one v->u halfedge across its
    # two copies, so the sides always balance: pair each u->v halfedge with
    # a v->u halfedge. Any perfect matching is a valid edge-manifold gluing
    # (Sharp & Crane SS2.2); we sort both sides by owning cover-triangle id
    # and prefer the pairing phase with fewer SELF-gluings (a face copy to
    # its own mirror) — zero for a consistently-oriented manifold interior
    # edge, which then reproduces the orientation double cover, while a
    # boundary edge (one side each) folds the two copies, closing the cover.
    lo = np.minimum(tail, head)
    hi = np.maximum(tail, head)
    key = lo.astype(np.int64) * (int(hi.max()) + 1) + hi
    order = np.argsort(key, kind="stable")
    twin = np.full(T * 3, -1, dtype=np.int64)
    ks = key[order]
    starts = np.flatnonzero(np.concatenate(([True], ks[1:] != ks[:-1])))
    ends = np.concatenate((starts[1:], [len(ks)]))
    for s, e in zip(starts, ends):
        grp = order[s:e]
        fwd = grp[tail[grp] == lo[grp[0]]]      # u->v side
        bwd = grp[tail[grp] != lo[grp[0]]]      # v->u side
        assert len(fwd) == len(bwd), "tufted cover: unbalanced edge sides"
        fwd = fwd[np.argsort(fwd // 3, kind="stable")]
        bwd = bwd[np.argsort(bwd // 3, kind="stable")]
        base = lambda h: (h // 3) % F           # underlying soup face
        if len(fwd) > 1:
            self0 = int(np.sum(base(fwd) == base(bwd)))
            rolled = np.roll(bwd, -1)
            if int(np.sum(base(fwd) == base(rolled))) < self0:
                bwd = rolled
        twin[fwd] = bwd
        twin[bwd] = fwd
    return tail, nxt, twin


def _corner_cot(la, lb, lc):
    """Cotangent of the angle OPPOSITE side c in a triangle with side
    lengths (a, b, c), from lengths only (mollified => area > 0)."""
    s = 0.5 * (la + lb + lc)
    area2 = np.maximum(s * (s - la) * (s - lb) * (s - lc), 1e-300)
    return (la * la + lb * lb - lc * lc) / (4.0 * np.sqrt(area2))


def _delaunay_flips(tail, nxt, twin, length, max_rounds: int = 50):
    """Flip non-Delaunay edges to convergence, in place.

    An interior edge h is Delaunay when cot(alpha) + cot(beta) >= 0 with
    alpha/beta the angles opposite h in its two triangles. Flips use the
    standard intrinsic-flattening length for the new diagonal and are
    skipped when the flattened quad is non-convex (can only happen on
    still-degenerate data; the mollified metric makes genuine non-Delaunay
    edges flippable). Returns the number of flips performed."""
    H = len(tail)
    eps = 1e-12

    def cot_opposite(h):
        a = length[nxt[h]]
        b = length[nxt[nxt[h]]]
        return _corner_cot(a, b, length[h])

    # seed: only the initially non-Delaunay edges (vectorized screen) — a
    # flip can only change the Delaunay status of the 5 edges it touches,
    # and those are re-enqueued below, so untouched Delaunay edges never
    # need a visit
    cot_all = _corner_cot(length[nxt], length[nxt[nxt]], length)
    viol = cot_all + cot_all[twin] < -eps
    stack = list(np.flatnonzero((np.arange(H) < twin) & viol))
    in_stack = np.zeros(H, dtype=bool)
    in_stack[stack] = True
    n_flips = 0
    budget = max_rounds * (H // 2)   # pathology guard only (iDT terminates)
    while stack:
        h = stack.pop()
        in_stack[h] = False
        t = twin[h]
        if cot_opposite(h) + cot_opposite(t) >= -eps:
            continue
        if n_flips >= budget:
            break  # safety net; the operator is still valid, just not iDT
        # triangles: (h, h1, h2) and (t, t1, t2)
        h1, h2 = nxt[h], nxt[nxt[h]]
        t1, t2 = nxt[t], nxt[nxt[t]]
        if h1 == t or t1 == h:       # degenerate cover cell; cannot flip
            continue
        c = length[h]
        # flatten: u=(0,0), v=(c,0); apex w1 above (triangle of h),
        # w2 below (triangle of t)
        x1 = (length[h2] ** 2 + c * c - length[h1] ** 2) / (2.0 * c)
        y1 = np.sqrt(max(length[h2] ** 2 - x1 * x1, 0.0))
        x2 = (length[t1] ** 2 + c * c - length[t2] ** 2) / (2.0 * c)
        y2 = -np.sqrt(max(length[t1] ** 2 - x2 * x2, 0.0))
        if y1 <= eps or -y2 <= eps:
            continue                 # flattened quad degenerate: skip
        # the new diagonal must cross the old edge strictly inside (0, c)
        s = y1 / (y1 - y2)
        xc = x1 + s * (x2 - x1)
        if not (eps < xc < c - eps):
            continue                 # non-convex quad: flip invalid
        ln = float(np.hypot(x2 - x1, y2 - y1))
        w1, w2 = tail[h2], tail[t2]
        # rewire (see module docstring): new triangles (u, w2, w1) =
        # (t1, h, h2) and (w2, v, w1) = (t2, h1, t)
        nxt[t1], nxt[h], nxt[h2] = h, h2, t1
        nxt[t2], nxt[h1], nxt[t] = h1, t, t2
        tail[h], tail[t] = w2, w1
        length[h] = length[t] = max(ln, eps)
        n_flips += 1
        for e in (h1, h2, t1, t2):
            r = min(e, twin[e])
            if not in_stack[r]:
                in_stack[r] = True
                stack.append(r)
    return n_flips


def tufted_laplacian(verts: np.ndarray, faces: np.ndarray,
                     mollify_factor: float = 1e-6, flip: bool = True):
    """(L, mass) from the tufted intrinsic-Delaunay cover of a triangle soup.

    verts: (V,3) float; faces: (F,3) int — nonmanifold edges, inconsistent
    orientation and slivers all allowed. Returns (csc float64 PSD L, (V,)
    float64 mass), scaled by 1/2 so a manifold, already-Delaunay mesh
    reproduces `cotan_laplacian`/`vertex_areas` exactly (up to
    mollification's uniform length delta).

    flip=False skips intrinsic Delaunay refinement (then the result equals
    the raw soup assembly of `mesh_laplacian_robust`)."""
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    faces = faces[ok]
    if faces.shape[0] == 0:
        raise ValueError("tufted_laplacian: no non-degenerate faces")
    V = verts.shape[0]

    tail, nxt, twin = _build_cover(faces)

    # intrinsic lengths (mollified on the SINGLE soup — doubling duplicates
    # triangles, so the mollification delta is identical)
    p = verts[faces]
    l_soup = np.stack([
        np.linalg.norm(p[:, 1] - p[:, 2], axis=-1),
        np.linalg.norm(p[:, 2] - p[:, 0], axis=-1),
        np.linalg.norm(p[:, 0] - p[:, 1], axis=-1),
    ], axis=-1)
    l_soup = _intrinsic_mollify(l_soup, rel_factor=mollify_factor)
    # halfedge 3t+c runs corner c -> c+1, whose length is the side OPPOSITE
    # corner c+2: front triangle (i,j,k) side order (|ij|,|jk|,|ki|) =
    # (l2, l0, l1); back triangle (k,j,i): (|kj|,|ji|,|ik|) = (l0, l2, l1)
    front_len = l_soup[:, [2, 0, 1]]
    back_len = l_soup[:, [0, 2, 1]]
    length = np.concatenate([front_len, back_len], axis=0).reshape(-1)

    if flip:
        _delaunay_flips(tail, nxt, twin, length)

    # assemble on original vertices from the final triangulation
    H = len(tail)
    h = np.arange(H)
    # corner at tail[nxt[nxt[h]]] is opposite halfedge h
    la = length[nxt[h]]
    lb = length[nxt[nxt[h]]]
    cot = 0.5 * _corner_cot(la, lb, length[h])
    i = tail[h]
    j = tail[nxt[h]]
    rows = np.concatenate([i, j, i, j])
    cols = np.concatenate([j, i, i, j])
    vals = np.concatenate([-cot, -cot, cot, cot]) * 0.5   # cover counts x2
    L = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(V, V)).tocsc()

    # barycentric mass from final intrinsic areas (each triangle contributes
    # a third of its area to each corner; halved for the double cover).
    # Triangles are the 3-cycles of `nxt` — NOT the index triples (3t, 3t+1,
    # 3t+2): _delaunay_flips rewires nxt/tail, so membership is only
    # recoverable by following nxt. One representative per cycle = the
    # halfedge that is the minimum of its cycle.
    rep = h[(h < nxt[h]) & (h < nxt[nxt[h]])]
    assert 3 * len(rep) == H, "tufted cover: nxt is not a disjoint 3-cycle set"
    a = length[rep]
    b = length[nxt[rep]]
    c = length[nxt[nxt[rep]]]
    s = 0.5 * (a + b + c)
    area = np.sqrt(np.maximum(s * (s - a) * (s - b) * (s - c), 0.0))
    mass = np.zeros(V, dtype=np.float64)
    for corner in (rep, nxt[rep], nxt[nxt[rep]]):
        np.add.at(mass, tail[corner], area / 6.0)
    mass[mass == 0.0] = (mass[mass > 0.0].mean() * 1e-8
                         if (mass > 0).any() else 1.0)
    return L, mass
