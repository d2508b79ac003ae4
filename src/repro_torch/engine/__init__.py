"""The PIM engine: ``program`` once, ``matmul`` many, over a registry of
named execution substrates."""
from repro_torch.engine.api import matmul, program
from repro_torch.engine.substrates import (Substrate, available_substrates,
                                           get_substrate, register_substrate)

__all__ = ["program", "matmul", "Substrate", "register_substrate",
           "get_substrate", "available_substrates"]
