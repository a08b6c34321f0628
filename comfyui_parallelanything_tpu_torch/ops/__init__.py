from .attention import get_attention_backend, set_attention_backend
from .basic import timestep_embedding

# ``attention`` stays the ``ops.attention`` module (the port's callers import it as
# ``from ...ops import attention``); the JAX package's ``ops.attention`` function is
# ``ops.attention.attention`` here (``NOT_EXPORTED`` in the package's ``__init__``).
__all__ = [
    "timestep_embedding",
    "set_attention_backend",
    "get_attention_backend",
]
