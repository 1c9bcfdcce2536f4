"""Multi-device paths of the port on ``torch.distributed``: one process a
rank, each rank one device.

Port of ``psignn_tpu/dist``:

* ``multihost`` — process groups (``initialize``, ``global_mesh``,
  ``is_coordinator``), the collectives and the rank launcher (``spawn``);
* ``dp`` — data parallelism over batched graphs: each rank its own shard,
  one all-reduce of gradients, losses and the adjoint solve's stats;
* ``partition`` — single-graph parallelism: edge-sharded message passing
  and SpMV, the RCM halo partition and the halo exchange;
* ``partitioned`` — the partitioned Ψ-GNN solve and train step: RCM node
  blocks, one halo exchange a layer, the solver on the blocks with the
  row's ``reduce`` hook; dp × partition;
* ``dryrun`` — the multi-rank dry run of every path above.
"""

from .dp import (dp_train_step, dp_value_and_grad, make_mesh, shard_stacked,
                 stack_graphs)
from .partition import partition_message_passing, partition_spmv
from .partitioned import (build_partitioned_graph, make_partitioned_function,
                          make_partitioned_loss, make_partitioned_train_step,
                          partitioned_psignn_inference,
                          partitioned_psignn_inference_dp,
                          stack_partitioned_graphs, unpartition)

__all__ = ["build_partitioned_graph", "dp_train_step", "dp_value_and_grad",
           "make_mesh", "make_partitioned_function", "make_partitioned_loss",
           "make_partitioned_train_step", "partition_message_passing",
           "partition_spmv", "partitioned_psignn_inference",
           "partitioned_psignn_inference_dp", "shard_stacked",
           "stack_graphs", "stack_partitioned_graphs", "unpartition"]
