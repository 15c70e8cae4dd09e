"""audiorenderingv2_tpu_torch — the acoustic renderer in PyTorch and CUDA.

A port of ``audiorenderingv2_tpu`` (JAX/Pallas) that runs the export path
(config -> scene -> ray trace -> binaural IR histogram -> FFT convolution ->
WAV), the multi-pose path (``multi.render_ir_matrix`` for S sources x L
listeners, ``multi.mix_sources``), the live path, the gradient path and
rays sharded over several GPUs (``parallel``, one process a GPU through
``torch.distributed``), broadband or banded, through hand-written CUDA
kernels on NVIDIA GPUs and their plain PyTorch versions on the CPU. It
never imports JAX; the JAX package stays the reference that the port's
tests compare against. Importing it builds nothing: the kernels are
compiled at their first launch.
"""

__version__ = "0.1.0"

from . import constants
from .config import (Config, MaterialSpec, PathtracerParams, RendererParams,
                     SceneParams, load_config, parse_config)
from .core.params import TraceParams
from .core.tracer import SceneArrays, TracerOptions, scene_to_arrays, trace_ir
from .scene import Scene, build_scene, load_scene

__all__ = [
    "constants",
    "Config", "MaterialSpec", "PathtracerParams", "RendererParams",
    "SceneParams", "load_config", "parse_config",
    "TraceParams", "TracerOptions", "SceneArrays", "scene_to_arrays",
    "trace_ir", "Scene", "build_scene", "load_scene",
]
