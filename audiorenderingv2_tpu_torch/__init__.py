"""audiorenderingv2_tpu_torch — the acoustic renderer in PyTorch and CUDA.

A port of ``audiorenderingv2_tpu`` (JAX/Pallas) that runs the export path
(config -> scene -> ray trace -> binaural IR histogram -> FFT convolution ->
WAV) and the multi-pose path (``multi.render_ir_matrix`` for S sources x L
listeners, ``multi.mix_sources``), broadband or banded, on one NVIDIA GPU
through hand-written CUDA kernels, and on the CPU through their plain
PyTorch versions. It never imports JAX; the JAX package
stays the reference that the port's tests compare against.
"""

__version__ = "0.1.0"
