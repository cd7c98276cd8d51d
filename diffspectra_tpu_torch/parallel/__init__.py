from .mesh import (  # noqa: F401
    Mesh,
    create_mesh,
    init_distributed,
    pmean_,
    rank_seed,
    replicate,
    shard_batch,
)
from .train_parallel import make_parallel_store_step, make_parallel_train_step  # noqa: F401
