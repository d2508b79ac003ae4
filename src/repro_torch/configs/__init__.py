"""Model configurations (a copy of ``repro.configs``)."""
from repro_torch.configs.base import (ModelConfig, get_config, list_archs,
                                     register)
