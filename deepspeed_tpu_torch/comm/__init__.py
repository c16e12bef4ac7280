"""Communication of the port (counterpart of ``deepspeed_tpu/comm``): the
collectives over ``torch.distributed`` (:mod:`.comm`), the mesh of process
groups (:mod:`.mesh`) and the host blockwise int8 codec (:mod:`.quant`)."""

from deepspeed_tpu_torch.comm.comm import (  # noqa: F401
    ReduceOp, all_gather, all_reduce, barrier, broadcast, broadcast_object_list,
    configure, counters, destroy, get_local_rank, get_rank, get_world_size,
    init_distributed, is_initialized, log_summary, new_group, reduce_scatter,
    reset_counters)
from deepspeed_tpu_torch.comm.mesh import (  # noqa: F401
    MESH_AXES, build_mesh, get_data_parallel_world_size, get_global_mesh,
    mesh_from_config, set_global_mesh)
