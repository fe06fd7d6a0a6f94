"""Training and inference over several cards, one process a card: the
(data, vert) mesh, data-parallel training, the vertex-sharded model and
its two-axis train step, and process-group set-up. The counterpart of
diffusionnet_tpu/parallel/."""

from .mesh import (VertexGroup, all_reduce_sum, data_parallel_sharding,
                   make_mesh, replicated_sharding, vertex_sharding)
from .data_parallel import make_dp_eval_step, make_dp_train_step
from .vertex_sharded import (make_two_axis_eval_step,
                             make_two_axis_train_step, shard_batch,
                             shard_operators_by_vertex,
                             vertex_sharded_forward,
                             vertex_sharded_megakernel_forward)
from .distributed import (initialize, launch, make_pod_mesh, rank_device,
                          run_multiprocess_dryrun)
