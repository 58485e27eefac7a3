"""The parallel path of the port: one process a rank, explicit collectives
(mesh.py), the leaves' split (sharding.py), the kernels per rank
(tp_kernels.py) and lockstep serving (multihost.py)."""

from llamago_tpu_torch.parallel.mesh import (  # noqa: F401
    initialize_distributed,
    make_mesh,
)
from llamago_tpu_torch.parallel.sharding import (  # noqa: F401
    cache_sharding,
    param_shardings,
)
