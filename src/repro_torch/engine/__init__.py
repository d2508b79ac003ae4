"""The PIM engine: ``program`` once, ``matmul`` many, over a registry of
named execution substrates; ``save_plans`` / ``load_plans`` persist
programmed plans across restarts."""
from repro_torch.engine.api import matmul, program
from repro_torch.engine.persist import (PlanCorruptionError,
                                        build_plan_template,
                                        describe_plan_tree, load_plans,
                                        save_plans)
from repro_torch.engine.substrates import (Substrate, available_substrates,
                                           get_substrate, register_substrate)

__all__ = ["program", "matmul", "Substrate", "register_substrate",
           "get_substrate", "available_substrates", "save_plans",
           "load_plans", "describe_plan_tree", "build_plan_template",
           "PlanCorruptionError"]
