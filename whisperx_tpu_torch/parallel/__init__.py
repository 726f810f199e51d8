"""Scale-out: the (data, model) device mesh, tensor-parallel placement,
data-parallel pipelines and multi-process file sharding."""

from whisperx_tpu_torch.parallel.data_parallel import (
    DataParallelPipeline,
    data_parallel_transcribe,
    maybe_data_parallel,
)
from whisperx_tpu_torch.parallel.multihost import initialize_multihost, shard_files
from whisperx_tpu_torch.parallel.sharding import (
    get_mesh,
    make_mesh,
    set_mesh,
    shard,
    use_mesh,
    shard_params_tp,
    walk_params_tp,
)

__all__ = [
    "DataParallelPipeline",
    "data_parallel_transcribe",
    "initialize_multihost",
    "shard_files",
    "get_mesh",
    "make_mesh",
    "maybe_data_parallel",
    "set_mesh",
    "shard",
    "use_mesh",
    "shard_params_tp",
    "walk_params_tp",
]
