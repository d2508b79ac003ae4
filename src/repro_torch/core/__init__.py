"""OPIMA core: the paper's contribution as composable PyTorch modules
(counterpart of ``repro/core``, with the same exports).

 - arch/cell: OPCM device + memory-organization models (Fig. 2 DSE)
 - pim: the bit-sliced PIM matmul datapath (exact + analog modes)
 - mapping/perfmodel: CNN->subarray mapping + latency/energy/power analyzer
 - baselines: comparison-platform models (Figs. 10-12)
 - workloads: Table-II CNN layer specs
"""
from repro_torch.core.arch import DEFAULT_ARCH, OpimaArch
from repro_torch.core.cell import (CellDesign, DEFAULT_CELL, best_design,
                                   design_space)
from repro_torch.core.pim import (DEFAULT_PIM, PimConfig,
                                  PlannedDepthwiseWeights, PlannedWeights,
                                  pim_depthwise_matmul, pim_linear,
                                  pim_matmul, plan_from_qtensor,
                                  prepare_depthwise_weights, prepare_weights,
                                  reference_quantized_matmul)
from repro_torch.core.perfmodel import (NetworkPerf, best_grouping,
                                        grouping_sweep, network_perf,
                                        power_breakdown_w, total_power_w)
from repro_torch.core.baselines import (ALL_PLATFORMS, PAPER_RATIOS,
                                        average_ratios, comparison_table)
