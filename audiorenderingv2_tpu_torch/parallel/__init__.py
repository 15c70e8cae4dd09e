"""Several GPUs through ``torch.distributed``, one process each: rays
sharded over ranks (``sharding``) and the file convolution's segments
sharded over ranks (``ir_sharding``). The counterpart of
``audiorenderingv2_tpu/parallel/``, with its eight public names."""
from .ir_sharding import SEG_AXIS, convolve_file_sharded, make_segment_mesh
from .sharding import (
    RAYS_AXIS,
    init_distributed,
    make_ray_mesh,
    render_ir_sharded,
    trace_directions_sharded,
)

__all__ = [
    "RAYS_AXIS", "init_distributed", "make_ray_mesh",
    "render_ir_sharded", "trace_directions_sharded",
    "SEG_AXIS", "convolve_file_sharded", "make_segment_mesh",
]
