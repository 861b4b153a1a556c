"""Model configurations of the port (copies of the JAX package's, not
imports): ``get_config(name)`` and ``get_smoke_config(name)``."""
from repro_torch.configs.registry import get_config, get_smoke_config

__all__ = ["get_config", "get_smoke_config"]
