"""dp x tp parallelism over ``torch.distributed``: guarded process-group
initialization (``distributed.py``) and the mesh, its sharding rules and
the tensor-parallel operators (``mesh.py``).  The names the JAX package's
``music2midi_tpu/parallel`` exports, with the same meanings."""

from .distributed import (  # noqa: F401
    maybe_initialize as maybe_initialize_distributed,
)
from .mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    param_shardings,
    replicate,
    stacked_batch_sharding,
)
