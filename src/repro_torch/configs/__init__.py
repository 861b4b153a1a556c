"""Model configurations of the port (copies of the JAX package's, not
imports): ``get_config(name)``, ``get_smoke_config(name)`` and
``list_archs()``."""
from repro_torch.configs.registry import (get_config, get_smoke_config,
                                          list_archs)

__all__ = ["get_config", "get_smoke_config", "list_archs"]
