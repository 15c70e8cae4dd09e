"""K7, the version-1 bounce round: rays in rows.

The counterpart of the TPU kernel
``audiorenderingv2_tpu/ops/raytrace_pallas.py:_trace_round_kernel``
(launched by ``trace_round``, :441): the physics of K1 over a row-major ray
state [N, 16] and the untrimmed triangle table [17, T] of
``raytrace_cuda.pack_tris_v1``, T a multiple of 128. One band; the nearest
hit with the lowest index on ties; the receiver sphere before the surface;
columns 13-15 (RAYID, LTRI, RECVD) written as zeros: version 1 records no
topology.

``trace_round_v1`` launches ``ar2_trace_round_v1`` of
``csrc/trace_round.cu`` for a CUDA tensor and runs ``trace_round_v1_plain``
for a CPU tensor. The TPU kernel holds a tile of rays in sublanes and sweeps
128-triangle lane chunks. On the card K7 is K1's kernel over these layouts:
each block transposes the table into K1's triangle rows in shared memory up
to the last valid column (a 12-triangle room in 128 columns tests 12), the
test reads a row as four float4 broadcasts, and a round of more than 32
bounces runs on a persistent grid whose lanes take the warp's next ray when
theirs ends; a ray reads and writes its 64-byte row as four 16-byte loads
and stores. A table of more than ``V1_CHUNK_COLS`` columns takes the
block-synchronous branch (:func:`v1_branch`). What bounds it is FP32
throughput in the search, about 40 operations per ray and valid triangle.
"""
from __future__ import annotations

import torch

from ..core.params import TraceParams
from . import _build
from . import raytrace_cuda as rc

# Kernel launches since import (or since a caller reset them to 0).
trace_round_v1_launches = 0

_ROWS = 17  # rows of the triangle table; absorption at 15, valid at 16
_V_ABS, _V_VAL = 15, 16
_NCOLS = 16


# Columns K7 stages at once: K1's chunk (kChunk, csrc/trace_round.cu).
V1_CHUNK_COLS = rc.K1_CHUNK_ROWS


def v1_branch(n_cols: int) -> str:
    """The branch of K7 that a table of ``n_cols`` columns takes:
    ``"one_chunk"`` up to V1_CHUNK_COLS (the table staged once a block as
    K1's rows up to its last valid column; a lane whose ray ends takes the
    warp's next one, on a persistent grid in rounds of more than 32
    bounces); ``"multi_chunk"`` above (the columns staged in chunks, blocks
    in step)."""
    if n_cols < 0:
        raise ValueError(f"a column count is >= 0, got {n_cols}")
    return "one_chunk" if n_cols <= V1_CHUNK_COLS else "multi_chunk"


def _table_as_rows(tris: torch.Tensor) -> torch.Tensor:
    """The [17, T] table in K1's row layout [T, 24], which the plain search
    and the shared bounce tail read (the kernel stages the same rows)."""
    rows = torch.zeros((tris.shape[1], rc._NR), dtype=torch.float32,
                       device=tris.device)
    rows[:, :rc._R_VAL] = tris[:_V_ABS].T
    rows[:, rc._R_VAL] = tris[_V_VAL]
    rows[:, rc._R_ABS] = tris[_V_ABS]
    return rows


def trace_round_v1_plain(state: torch.Tensor, tris: torch.Tensor,
                         scal: torch.Tensor, params: TraceParams,
                         round_budget: int) -> torch.Tensor:
    """Plain PyTorch version of K7: advance every ray (row) of ``state``
    [N, 16] by up to ``round_budget`` bounces, in place. Each bounce gathers
    the rows that are not done yet, steps them through K1's search and tail,
    and scatters them back."""
    rows = _table_as_rows(tris)
    for _ in range(round_budget):
        idx = torch.nonzero(state[:, rc._C_DONE] == 0.0).squeeze(1)
        if idx.numel() == 0:
            break
        s = state[idx].T.contiguous()
        rc._bounce(s, rows, scal, [rc._C_EN], [rc._C_EVW],
                   params.max_bounces)
        state[idx] = s.T
    state[:, rc._C_RAYID:] = 0.0
    return state


def _check_v1(state, tris, scal, params, round_budget) -> None:
    for name, x in (("state", state), ("tris", tris), ("scal", scal)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{x.dtype}")
        if x.device != state.device:
            raise ValueError(f"{name} on {x.device}, state on "
                             f"{state.device}")
    if params.n_bands != 1:
        raise ValueError(f"the version-1 kernel carries one band, params "
                         f"ask for {params.n_bands}")
    if state.dim() != 2 or state.shape[1] != _NCOLS:
        raise ValueError(f"state must be row-major [N, {_NCOLS}], got "
                         f"{tuple(state.shape)}")
    if tris.dim() != 2 or tris.shape[0] != _ROWS:
        raise ValueError(f"tris must be [{_ROWS}, T], got "
                         f"{tuple(tris.shape)}")
    if tris.shape[1] % rc._LANES:
        raise ValueError(f"triangle count {tris.shape[1]} not a multiple of "
                         f"{rc._LANES}")
    if scal.shape != (rc._NSCAL,):
        raise ValueError(f"scal must be [{rc._NSCAL}], got "
                         f"{tuple(scal.shape)}")
    if int(round_budget) < 1:
        raise ValueError(f"round budget must be >= 1, got {round_budget}")


def trace_round_v1(state: torch.Tensor, tris: torch.Tensor,
                   scal: torch.Tensor, params: TraceParams,
                   round_budget: int) -> torch.Tensor:
    """K7: advance every ray (row) of ``state`` [N, 16] by up to
    ``round_budget`` bounces over ``tris`` [17, T], in place; returns
    ``state``. ``scal`` is the scalar row [16]. A CUDA tensor goes to the
    kernel, a CPU tensor to :func:`trace_round_v1_plain`."""
    global trace_round_v1_launches
    _check_v1(state, tris, scal, params, round_budget)
    if state.device.type == "cpu":
        return trace_round_v1_plain(state, tris, scal, params,
                                    int(round_budget))
    if state.device.type != "cuda":
        raise ValueError(f"no trace kernel for device {state.device}")
    lib = _build.library()
    err = lib.ar2_trace_round_v1(
        state.data_ptr(), state.shape[0], tris.data_ptr(), tris.shape[1],
        scal.data_ptr(), int(round_budget), params.max_bounces,
        _build.stream(state.device))
    trace_round_v1_launches += 1
    _build.check(err, "ar2_trace_round_v1")
    return state
