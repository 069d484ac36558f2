"""Scale-out over ranks on ``torch.distributed`` (counterpart of
``tile_match_tpu.parallel``).

Batch-of-independent-envs parallelism: env states split over a ``dp`` mesh
axis with no communication on the step path, metrics reduce with
``all_reduce``, and the learner's gradients all-reduce over ``dp`` while
its hidden layers may split over a ``tp`` axis.  ``launch`` runs a
function in several spawned ranks on one host.
"""

from .distributed import all_hosts_mean, initialize_distributed, launch
from .sharding import (
    gather_boards,
    make_mesh,
    shard_env_batch,
    sharded_rollout,
    sharded_train_step,
)

__all__ = [
    "make_mesh",
    "shard_env_batch",
    "sharded_rollout",
    "sharded_train_step",
    "gather_boards",
    "initialize_distributed",
    "all_hosts_mean",
    "launch",
]
