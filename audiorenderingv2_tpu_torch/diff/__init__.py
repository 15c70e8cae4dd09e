"""The gradient path: record path topology, replay it differentiably, fit
scene parameters to a target IR. The counterpart of
``audiorenderingv2_tpu/diff/``; ``record_paths_kernels`` stands where that
package has ``record_paths_pallas``."""
from .inverse import (
    FitResult,
    coarse_emitter_search,
    emitter_grid,
    fit_scene_parameters,
    ir_loss,
    material_ids_padded,
    render_soft_ir,
    smooth_ir,
    with_material_absorption,
)
from .replay import (record_paths, record_paths_kernels, render_ir_replay,
                     replay_events)

__all__ = [
    "FitResult", "coarse_emitter_search", "emitter_grid",
    "fit_scene_parameters", "ir_loss", "material_ids_padded",
    "record_paths", "record_paths_kernels", "render_ir_replay",
    "render_soft_ir", "replay_events",
    "smooth_ir", "with_material_absorption",
]
