from .mesh import (
    DATA_AXIS,
    PARTICLE_AXIS,
    active_mesh,
    constrain_bs,
    constrain_bsd,
    constrain_rows,
    get_active_mesh,
    make_mesh,
    mesh_signature,
)
from .distributed import (
    initialize_distributed,
    measure_queries_per_s,
    scaling_efficiency,
)
