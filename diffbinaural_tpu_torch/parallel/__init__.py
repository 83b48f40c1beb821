from .mesh import (
    initialize_multihost,
    make_mesh,
    shard_batch,
    replicate,
    data_sharding,
    shard_vocoder_params,
)
