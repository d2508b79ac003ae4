"""The PIM engine: ``program`` once, ``matmul`` many, over a registry of
named execution substrates; ``save_plans`` / ``load_plans`` persist
programmed plans across restarts; ``shard_plan`` / ``shard_plan_tree``
split plans over a mesh of ranks."""
from repro_torch.engine.api import matmul, program
from repro_torch.engine.mesh import PlanShard, shard_plan, shard_plan_tree
from repro_torch.engine.persist import (PlanCorruptionError,
                                        build_plan_template,
                                        describe_plan_tree, load_plans,
                                        save_plans)
from repro_torch.engine.substrates import (Substrate, available_substrates,
                                           get_substrate, register_substrate)

__all__ = ["program", "matmul", "Substrate", "register_substrate",
           "get_substrate", "available_substrates", "save_plans",
           "load_plans", "describe_plan_tree", "build_plan_template",
           "PlanCorruptionError", "PlanShard", "shard_plan",
           "shard_plan_tree"]
