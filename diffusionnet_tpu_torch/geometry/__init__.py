"""Geometry precompute: Laplacians (cotan, robust, tufted, point clouds),
tangent frames, gradients, the eigensolvers (the device solver on kernel
B5, and host ARPACK), geodesics (native exact, Steiner and graph; the heat
method on the host and on the card), mesh IO, the host kNN, and the
Operators bundle with caching, padding and a host-parallel precompute."""

from .operators import (
    Operators,
    compute_operators,
    get_operators,
    get_all_operators,
    pad_operators,
    stack_operators,
    spectral_gradients,
    grad_operators,
)
from .laplacian import cotan_laplacian, vertex_areas, face_areas_np
from .gradients import build_grad, build_grad_point_cloud
from .point_cloud import point_cloud_laplacian, mesh_laplacian_robust
from .tufted import tufted_laplacian
from .eigen import (EigenSolveNotConverged, eigensolve_device,
                    eigensolve_device_sharded, eigensolve_host)
from .geodesics import (
    HeatMethodSolver,
    get_all_pairs_geodesic_distance,
    geodesic_label_errors,
)
from .heat_device import DeviceHeatMethodSolver, all_pairs_heat_device
from .io import (read_mesh, read_off, read_obj, read_ply, write_mesh,
                 write_off, write_obj, write_ply)
from .knn_host import find_knn_host
from .parallel_precompute import (get_all_operators_parallel,
                                  precompute_shard_for_host)
from .host_frames import (
    build_tangent_frames_np,
    edge_tangent_vectors_np,
    vertex_normals_np,
    mesh_vertex_normals_np,
)
