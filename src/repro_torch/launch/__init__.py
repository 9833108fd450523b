# Launch layer: device meshes on torch.distributed, the production-mesh
# dry-run on fake devices, its per-device step counter and the H100
# roofline. `dryrun` and `report` stay script-style entry points
# (python -m repro_torch.launch.dryrun / .report).
from .hlo_analysis import (CollectiveStats, StepCounter, analyze_collectives,
                           cost_analysis_dict)
from .mesh import (make_host_mesh, make_mesh, make_production_mesh,
                   start_process_group, stop_process_group)
from .roofline import (F32_PEAK_FLOPS, HBM_BW, NVLINK_BW, PEAK_FLOPS,
                       RooflineTerms, count_params, model_flops,
                       terms_from_analysis)

__all__ = ["make_mesh", "make_production_mesh", "make_host_mesh",
           "start_process_group", "stop_process_group",
           "CollectiveStats", "StepCounter", "analyze_collectives",
           "cost_analysis_dict", "RooflineTerms", "terms_from_analysis",
           "count_params", "model_flops", "PEAK_FLOPS", "F32_PEAK_FLOPS",
           "HBM_BW", "NVLINK_BW"]
