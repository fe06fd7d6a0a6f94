"""The port's native host library (C++, ctypes), built with g++ at first
use: KD-tree kNN, the point-cloud triangle soup, graph, Steiner and exact
(ICH) geodesics, and a threaded CSR SpMM. The counterpart of
diffusionnet_tpu/native/; a failed build raises, and no caller falls back."""

from .build import (  # noqa: F401
    get_lib, knn_native, dijkstra_geodesics_native, steiner_geodesics_native,
    exact_geodesics_native, cloud_triangles_native, csr_spmm_native,
)
