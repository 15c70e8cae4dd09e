"""The file convolution with its 1 s segment axis sharded over processes.

The counterpart of ``audiorenderingv2_tpu/parallel/ir_sharding.py``:

  * each rank holds a contiguous run of the overlap-add's 1 s segments and
    runs the same batched rfft -> multiply -> irfft as the single-process
    engine (``ops/convolve.py``);
  * the overlap-add is local except for the tail: a segment's circular
    result spans ``k = ir_length / sample_rate`` seconds, so the last
    ``k - 1`` seconds of each rank's sum spill into the following ranks'
    spans. That halo goes forward along the ring, one ``batch_isend_irecv``
    (send to ``rank + 1``, receive from ``rank - 1``) a hop, where the JAX
    package has a ``ppermute``;
  * the wrap edge (the last rank's spill arriving at rank 0) lies past the
    signal's end and is dropped, like the single-process truncation;
  * one all-gather gives every rank the whole ``[2, L]``, as JAX's global
    array does.

Gloo's point-to-point and all-gather take CPU tensors only: on the GPU this
path needs NCCL.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.convolve import _ola_segments, _overlap_add, _to_length
from .sharding import Mesh, make_mesh

SEG_AXIS = "segments"


def make_segment_mesh(group=None, device=None) -> Mesh:
    """The ``segments`` mesh over ``group`` (see ``sharding.make_mesh``)."""
    return make_mesh(SEG_AXIS, group, device)


def _ring_forward(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Send ``x`` to rank + 1; return what rank - 1 sent. A world of one
    gets its own ``x`` back without a send (gloo refuses a send to
    itself)."""
    if mesh.size == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    peer = lambda r: dist.get_global_rank(mesh.group, r % mesh.size)  # noqa
    ops = [dist.P2POp(dist.isend, x, peer(mesh.rank + 1), mesh.group),
           dist.P2POp(dist.irecv, out, peer(mesh.rank - 1), mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _gather_time(own: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's [2, n] span, in rank order along time: [2, world * n]."""
    if mesh.group is None:
        return own
    parts = [torch.empty_like(own) for _ in range(mesh.size)]
    dist.all_gather(parts, own.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=1)


def convolve_file_sharded(samples, ir_stereo, sample_rate: int,
                          mesh: Mesh | None = None) -> torch.Tensor:
    """Overlap-add convolution with the segment axis sharded over the mesh.

    Args:
      samples: float [L] mono signal (whole seconds are processed, the
        output has length L: the reference's contract).
      ir_stereo: float [2, ir_length]; ir_length a whole number of seconds.
      mesh: default ``make_segment_mesh()``. The segment count is padded
        with silent segments until the last real segment's spill fits and
        the count divides by the world size.

    Returns float32 [2, L] on every rank, on the rank's device: equal to
    ``convolve_file_stereo`` up to f32 summation order.
    """
    mesh = mesh or make_segment_mesh()
    ir_stereo = torch.as_tensor(ir_stereo, dtype=torch.float32).to(
        mesh.device)
    samples = torch.as_tensor(samples, dtype=torch.float32).to(mesh.device)
    length = samples.shape[0]
    ir_length = ir_stereo.shape[-1]
    if ir_length % sample_rate != 0:
        raise ValueError("ir_length must be a multiple of sample_rate")
    k = ir_length // sample_rate

    segs = _ola_segments(samples, sample_rate, ir_length)  # [S, ir_length]
    s = segs.shape[0]
    if s == 0:
        return torch.zeros((2, length), dtype=torch.float32,
                           device=mesh.device)
    # Silent segments until the last real segment's k-1 second spill lies
    # inside the spans: the only halo that wraps (last rank -> rank 0) is
    # then silent, and dropping it loses nothing.
    s_pad = -(-(s + k - 1) // mesh.size) * mesh.size
    local_s = s_pad // mesh.size
    segs = torch.nn.functional.pad(segs, (0, 0, 0, s_pad - s))
    mine = segs[mesh.rank * local_s:(mesh.rank + 1) * local_s]

    spec = torch.fft.rfft(mine, dim=-1)[None] \
        * torch.fft.rfft(ir_stereo, dim=-1)[:, None, :]
    y = torch.fft.irfft(spec, n=ir_length, dim=-1)  # [2, local_s, irl]
    total = _overlap_add(y, sample_rate)  # [2, local_s + k - 1, sr]
    own = total[:, :local_s].clone()      # this rank's seconds
    carry = total[:, local_s:]            # spills into the following ranks
    # The halo reaches ceil((k-1)/local_s) ranks: each hop adds its first
    # local_s seconds to the receiver's span and forwards the rest. After
    # hop h, ranks 0..h hold what wrapped past the signal's end: zeroed.
    hops = -(-(k - 1) // local_s) if k > 1 else 0
    for h in range(hops):
        carry = _ring_forward(carry, mesh)
        if mesh.rank <= h:
            carry = torch.zeros_like(carry)
        take = min(local_s, carry.shape[1])
        own[:, :take] += carry[:, :take]
        carry = carry[:, take:]
        if carry.shape[1] == 0:
            break
    out = _gather_time(own.reshape(2, local_s * sample_rate), mesh)
    # Net factor 2: cuFFT's unnormalised scale over the reference's
    # ir_length/2 divide (ops/convolve.py).
    return _to_length(out, length) * 2.0
