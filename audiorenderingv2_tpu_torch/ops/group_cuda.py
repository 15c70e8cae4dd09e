"""K6, the bounce round over the group layout.

The counterpart of the group branch of the TPU kernel
``audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:_trace_round_kernel_v2``
(``group_step`` and its loop, launched by ``trace_round_v2`` with ``attrs``
set, :799): per group of 8 triangles one [48, 8] x [8, rays] product gives
the six plane and barycentric quantities of the Moller-Trumbore test, with
the ray packed as (px, py, pz, vx, vy, vz, 1, 0); then K1's hit test, its
tie rule (the lowest triangle index), the attribute pick and the bounce
tail. The operands come from ``raytrace_cuda.pack_tris_group``.

* ``trace_round_group`` launches ``csrc/trace_group.cu`` for a CUDA tensor
  and runs ``trace_round_group_plain`` for a CPU tensor. On the card the
  product is computed in the kernel's body, one thread per ray with the
  coefficient groups staged through shared memory; each of the 48 outputs
  is an eight-term sum in index order. What bounds it is FP32 throughput:
  about 96 operations per ray and triangle in the product, where K1's
  direct form needs about 40.
* ``precision``: ``"highest"`` keeps f32 throughout. The packing's zeros
  then add exactly, so the quantities, and with them every state column,
  equal K1's bit for bit up to the sign of a zero. ``"high"`` (the JAX
  package's ``"high"`` and ``"split3"``) splits both operands into a bf16
  high part and a bf16 low part and sums three products, high x high + high x low + low x high, each
  accumulated in f32 in index order: about 2^-17 relative, the form a
  tensor-core version of this kernel would take.

The plain version repeats the kernel's arithmetic operation by operation,
so on the card the two agree bit for bit at both precisions.
"""
from __future__ import annotations

import math

import torch

from .. import constants
from ..core.params import TraceParams
from . import _build
from . import raytrace_cuda as rc

# Kernel launches since import (or since a caller reset them to 0): with one
# scalar row, and with a row per pose (``scal`` [P, 16]).
trace_round_group_launches = 0
trace_round_group_posed_launches = 0

_T_NX, _T_NY, _T_NZ, _T_ABS = range(4)  # attribute columns


PRECISIONS = ("highest", "high")


def check_precision(precision: str) -> None:
    """Refuse a precision this kernel does not have. The JAX package's
    ``"default"`` is one bf16 pass over the product, 8 bits of mantissa for
    positions, which its own kernel calls corrupt geometry: it has no
    counterpart here."""
    if precision == "default":
        raise ValueError("precision 'default' is a single bf16 pass over "
                         "the geometry product, which corrupts positions; "
                         "use 'highest' or 'high'")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")


def _split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x as hi + lo, both exactly representable in bf16 (round to nearest
    even), returned as f32."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    lo = (x - hi).to(torch.bfloat16).to(torch.float32)
    return hi, lo


def _dot8(a: torch.Tensor, p: list) -> torch.Tensor:
    """a [c, 8] times the 8 ray rows ``p`` ([k] each) -> [c, k], the eight
    terms added in index order."""
    acc = a[:, 0:1] * p[0][None, :]
    for j in range(1, 8):
        acc = acc + a[:, j:j + 1] * p[j][None, :]
    return acc


def _quantity_tables(coeffs: torch.Tensor, high: bool):
    """The coefficients as [6, T, 8], quantity-major then triangle-major;
    with ``high`` its (hi, lo) split, else (table, None)."""
    g = coeffs.shape[0] // rc._AROWS
    q = coeffs.view(g, rc._NQ, rc._GROUP, 8).permute(1, 0, 2, 3)
    q = q.reshape(rc._NQ, g * rc._GROUP, 8).contiguous()
    return _split_bf16(q) if high else (q, None)


def _nearest_hit_group(s: torch.Tensor, tables, valid: torch.Tensor,
                       high: bool, chunk: int = 64):
    """Nearest valid hit of the rays ``s`` [ncols, k] through the group
    product: (t [k], inf on a miss; triangle index [k]). Ties go to the
    lowest index."""
    k = s.shape[1]
    dev = s.device
    pd = [s[c] for c in range(rc._C_PX, rc._C_VZ + 1)]
    pd += [torch.ones(k, device=dev), torch.zeros(k, device=dev)]
    if high:
        ph, pl = zip(*[_split_bf16(x) for x in pd])
    t_hi, t_lo = tables
    best_t = torch.full((k,), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.zeros((k,), dtype=torch.int64, device=dev)
    for c0 in range(0, valid.shape[0], chunk):
        c = slice(c0, c0 + chunk)

        def quantity(q):
            if not high:
                return _dot8(t_hi[q, c], pd)
            return ((_dot8(t_hi[q, c], ph) + _dot8(t_hi[q, c], pl))
                    + _dot8(t_lo[q, c], ph))

        no, nd, ou, du, ov, dv = (quantity(q) for q in range(rc._NQ))
        safe = torch.abs(nd) > 1e-12
        t = -no / torch.where(safe, nd, 1.0)
        u = ou + t * du
        v = ov + t * dv
        ok = (safe & (t > constants.T_MIN)
              & (u >= -1e-7) & (v >= -1e-7) & (u + v <= 1.0 + 1e-7)
              & (valid[c, None] > 0))
        ct, ci = torch.where(ok, t, math.inf).min(dim=0)
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_i = torch.where(better, ci + c0, best_i)
    return best_t, best_i


def _attrs_as_rows(attrs: torch.Tensor, n_bands: int) -> torch.Tensor:
    """The attribute table in K1's row layout, [T, 24] with only the
    normal, the valid flag and the absorptions filled: what the shared
    bounce tail reads of the triangle it bounced off."""
    rows = torch.zeros((attrs.shape[0], rc._NR), dtype=torch.float32,
                       device=attrs.device)
    rows[:, rc._R_NX:rc._R_NZ + 1] = attrs[:, _T_NX:_T_NZ + 1]
    rows[:, rc._R_VAL] = attrs[:, _T_ABS + n_bands]
    rows[:, rc._R_ABS:rc._R_ABS + n_bands] = \
        attrs[:, _T_ABS:_T_ABS + n_bands]
    return rows


def trace_round_group_plain(state: torch.Tensor, coeffs: torch.Tensor,
                            attrs: torch.Tensor, scal: torch.Tensor,
                            params: TraceParams, round_budget: int,
                            rays_per_pose: int | None = None,
                            precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch version of K6: advance every ray by up to
    ``round_budget`` bounces, in place, the nearest hit found through the
    group product and the rest of the bounce by K1's tail. ``precision``
    is one of ``PRECISIONS``; :func:`trace_round_group` checks it."""
    high = precision == "high"
    en_cols, evw_cols = rc.band_cols(params.n_bands)
    tables = _quantity_tables(coeffs, high)
    rows = _attrs_as_rows(attrs, params.n_bands)
    valid = rows[:, rc._R_VAL]
    state[rc._C_LTRI] = 0.0
    for _ in range(round_budget):
        idx = torch.nonzero(state[rc._C_DONE] == 0.0).squeeze(1)
        if idx.numel() == 0:
            break
        s = state[:, idx]
        best = _nearest_hit_group(s, tables, valid, high)
        rc._bounce(s, rows, rc.pose_rows(scal, idx, rays_per_pose), en_cols,
                   evw_cols, params.max_bounces, best=best)
        state[:, idx] = s
    return state


def _check_group(state, coeffs, attrs, scal, n_bands, round_budget) -> None:
    for name, x in (("state", state), ("coeffs", coeffs), ("attrs", attrs),
                    ("scal", scal)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{x.dtype}")
        if x.device != state.device:
            raise ValueError(f"{name} on {x.device}, state on "
                             f"{state.device}")
    if state.dim() != 2 or state.shape[0] != rc.state_ncols(n_bands):
        raise ValueError(f"state must be [{rc.state_ncols(n_bands)}, N] for "
                         f"{n_bands} band(s), got {tuple(state.shape)}")
    if coeffs.dim() != 2 or coeffs.shape[1] != 8 \
            or coeffs.shape[0] % rc._AROWS:
        raise ValueError(f"coeffs must be [G * {rc._AROWS}, 8], got "
                         f"{tuple(coeffs.shape)}")
    groups = coeffs.shape[0] // rc._AROWS
    if attrs.shape != (groups * rc._GROUP, rc.attr_cols(n_bands)):
        raise ValueError(f"attrs must be [{groups * rc._GROUP}, "
                         f"{rc.attr_cols(n_bands)}] for {groups} group(s) "
                         f"and {n_bands} band(s), got {tuple(attrs.shape)}")
    if int(round_budget) < 1:
        raise ValueError(f"round budget must be >= 1, got {round_budget}")


def trace_round_group(state: torch.Tensor, coeffs: torch.Tensor,
                      attrs: torch.Tensor, scal: torch.Tensor,
                      params: TraceParams, round_budget: int,
                      rays_per_pose: int | None = None,
                      precision: str = "highest") -> torch.Tensor:
    """K6: advance every ray of ``state`` [ncols, N] by up to
    ``round_budget`` bounces over the group layout (``coeffs``, ``attrs``
    from ``raytrace_cuda.pack_tris_group``), in place; returns ``state``.
    ``scal`` is one scalar row [16], or [P, 16] for a pose-major state of P
    poses with ``rays_per_pose`` rays each. A CUDA tensor goes to the
    kernel, a CPU tensor to :func:`trace_round_group_plain`."""
    global trace_round_group_launches, trace_round_group_posed_launches
    check_precision(precision)
    _check_group(state, coeffs, attrs, scal, params.n_bands, round_budget)
    n_poses, rays_per_pose = rc.check_poses(state, scal, rays_per_pose)
    if state.device.type == "cpu":
        return trace_round_group_plain(state, coeffs, attrs, scal, params,
                                       int(round_budget), rays_per_pose,
                                       precision)
    if state.device.type != "cuda":
        raise ValueError(f"no trace kernel for device {state.device}")
    lib = _build.library()
    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = lib.ar2_trace_group(
        state.data_ptr(), state.shape[1], state.shape[0], coeffs.data_ptr(),
        attrs.data_ptr(), coeffs.shape[0] // rc._AROWS, attrs.shape[1],
        scal.data_ptr(), n_poses, rays_per_pose, params.n_bands,
        rc.layout_bands(params.n_bands), int(round_budget),
        params.max_bounces, int(precision == "high"), stream)
    if scal.dim() == 2:
        trace_round_group_posed_launches += 1
    else:
        trace_round_group_launches += 1
    _build.check(err, "ar2_trace_group")
    return state
