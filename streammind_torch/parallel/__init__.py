"""dp / fsdp / tp meshes over ``torch.distributed``: the mesh, the
partitioning rules and explicit shards, the collectives of the sharded
layers, and the layouts of serving state."""
from .mesh import (
    AXES,
    ambient_mesh,
    default_mesh,
    make_mesh,
    replicated,
    set_mesh,
    single_device_mesh,
)
from .partitioning import (
    gather_params,
    local_shard,
    param_specs,
    shard_params,
    spec_for,
)
from .serving import (
    kv_cache_specs,
    mesh_fits_inference,
    shard_kv_cache,
    shard_stream_state,
    stream_state_specs,
)
