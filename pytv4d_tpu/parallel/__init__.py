from . import halo, mesh, multihost, tgv_sharded
from .halo import (
    make_sharded_cp_solver,
    sharded_cp_step,
    sharded_D,
    sharded_D_T,
    sharded_tv_and_subgrad,
)
from .tgv_sharded import tgv_denoise_sharded
from .mesh import (
    T_AXIS,
    Z_AXIS,
    d_volume_sharding,
    d_volume_spec,
    make_mesh,
    shard_volume,
    volume_sharding,
    volume_spec,
)
