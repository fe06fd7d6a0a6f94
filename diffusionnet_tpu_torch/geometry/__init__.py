"""Geometry precompute: cotan Laplacian, tangent frames, gradients, the
eigensolvers (the device solver on kernel B5, and host ARPACK), and the
Operators bundle with caching and padding."""

from .operators import (
    Operators,
    compute_operators,
    get_operators,
    pad_operators,
    stack_operators,
    spectral_gradients,
    grad_operators,
)
from .laplacian import cotan_laplacian, vertex_areas, face_areas_np
from .gradients import build_grad
from .eigen import EigenSolveNotConverged, eigensolve_device, eigensolve_host
from .host_frames import (
    build_tangent_frames_np,
    edge_tangent_vectors_np,
    vertex_normals_np,
    mesh_vertex_normals_np,
)
