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
  and runs ``trace_round_group_plain`` for a CPU tensor.
* ``precision``: ``"highest"`` keeps f32 throughout, the product in each
  lane with the ray's packed 1 and 0 folded (a quantity is six products
  added in index order, then the coefficient the 1 meets). The quantities,
  and with them every state column, equal K1's bit for bit up to the sign
  of a zero, on the card as in the plain version. ``"high"`` (the JAX
  package's ``"high"`` and ``"split3"``) splits both operands into a bf16
  high part and a bf16 low part and sums high x high + low x high + high x
  low. The plain version adds the terms in f32 in index order; the kernel
  runs the product on the tensor cores (``mma.sync``, bf16 in, f32
  accumulated), which add them in their own order, so the kernel meets its
  plain version on a bar (PERF.md), not bit for bit. The coefficients' split
  is made once per ``coeffs`` tensor (:func:`b_fragments`, cached: the
  renderer packs once per scene).
* ``products_high`` runs the kernel's product alone (the probe) and
  ``high_terms_f64`` gives the float64 sum of the same terms, the reference
  of its bar.
"""
from __future__ import annotations

import math

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import constants
from ..core.params import TraceParams
from . import _build
from . import raytrace_cuda as rc

# Kernel launches since import (or since a caller reset them to 0): with one
# scalar row, with a row per pose (``scal`` [P, 16]), and of the probe.
trace_round_group_launches = 0
trace_round_group_posed_launches = 0
group_probe_launches = 0

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


def _dot(a: torch.Tensor, p: list, one: bool = True) -> torch.Tensor:
    """a [c, 8] times the ray packed as (p[0..5], 1, 0) -> [c, k], ``p``
    the six ray rows ([k] each): the six products added in index order,
    then a[:, 6], the coefficient the packed 1 meets (a[:, 6] * 1 is
    a[:, 6] exactly; a[:, 7] meets the packed 0 and adds nothing). With
    ``one=False`` the packed 1 and 0 are both 0: the low parts of the
    ray."""
    acc = a[:, 0:1] * p[0][None, :]
    for j in range(1, 6):
        acc = acc + a[:, j:j + 1] * p[j][None, :]
    return acc + a[:, 6:7] if one else acc


def _quantity_tables(coeffs: torch.Tensor, high: bool):
    """The coefficients as [6, T, 8], quantity-major then triangle-major;
    with ``high`` its (hi, lo) split, else (table, None)."""
    g = coeffs.shape[0] // rc._AROWS
    q = coeffs.view(g, rc._NQ, rc._GROUP, 8).permute(1, 0, 2, 3)
    q = q.reshape(rc._NQ, g * rc._GROUP, 8).contiguous()
    return _split_bf16(q) if high else (q, None)


def _ray_rows(s: torch.Tensor, high: bool):
    """The six ray rows (px..vz) of ``s`` [ncols, k]: (rows, None), or with
    ``high`` their split (high parts, low parts)."""
    pd = [s[c] for c in range(rc._C_PX, rc._C_VZ + 1)]
    if not high:
        return pd, None
    ph, pl = zip(*[_split_bf16(x) for x in pd])
    return list(ph), list(pl)


def _quantity(tables, q: int, c: slice, rays, high: bool) -> torch.Tensor:
    """Quantity ``q`` of the triangles ``c`` for the rays: [c, k]."""
    t_hi, t_lo = tables
    ph, pl = rays
    if not high:
        return _dot(t_hi[q, c], ph)
    return ((_dot(t_hi[q, c], ph) + _dot(t_hi[q, c], pl, one=False))
            + _dot(t_lo[q, c], ph))


def _nearest_hit_group(s: torch.Tensor, tables, valid: torch.Tensor,
                       high: bool, chunk: int = 64):
    """Nearest valid hit of the rays ``s`` [ncols, k] through the group
    product: (t [k], inf on a miss; triangle index [k]). Ties go to the
    lowest index."""
    k = s.shape[1]
    dev = s.device
    rays = _ray_rows(s, high)
    best_t = torch.full((k,), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.zeros((k,), dtype=torch.int64, device=dev)
    for c0 in range(0, valid.shape[0], chunk):
        c = slice(c0, c0 + chunk)
        no, nd, ou, du, ov, dv = (_quantity(tables, q, c, rays, high)
                                  for q in range(rc._NQ))
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


def products_plain(state: torch.Tensor, coeffs: torch.Tensor,
                   precision: str = "high") -> torch.Tensor:
    """The 48 quantities of every group for every ray of ``state`` [ncols,
    N] as the plain version forms them: [N, G, 6, 8] (ray, group, quantity,
    triangle of the group)."""
    high = precision == "high"
    g = coeffs.shape[0] // rc._AROWS
    tables = _quantity_tables(coeffs, high)
    rays = _ray_rows(state, high)
    q = torch.stack([_quantity(tables, j, slice(None), rays, high)
                     for j in range(rc._NQ)])  # [6, T, N]
    return q.view(rc._NQ, g, rc._GROUP, -1).permute(3, 1, 0, 2).contiguous()


def high_terms_f64(state: torch.Tensor, coeffs: torch.Tensor):
    """The 20 terms of each "high" quantity in float64: (their sum, the sum
    of their magnitudes), [N, G, 6, 8] each. Every term is a product of two
    bf16 values, exact in f32, so the sum is exact to float64's rounding:
    the reference the tensor-core product is held to."""
    g = coeffs.shape[0] // rc._AROWS
    hi, lo = (x.double() for x in _quantity_tables(coeffs, True))
    ph, pl = _ray_rows(state, True)
    one = torch.ones_like(ph[0])
    rh = torch.stack([*ph, one]).double()  # [7, N]
    rl = torch.stack(pl).double()          # [6, N]
    total = hi[..., :7] @ rh + hi[..., :6] @ rl + lo[..., :7] @ rh
    mag = (hi[..., :7].abs() @ rh.abs() + hi[..., :6].abs() @ rl.abs()
           + lo[..., :7].abs() @ rh.abs())

    def order(x):
        return x.view(rc._NQ, g, rc._GROUP, -1).permute(3, 1, 0, 2)

    return order(total).contiguous(), order(mag).contiguous()


def b_fragments(coeffs: torch.Tensor) -> torch.Tensor:
    """The bf16 split of ``coeffs`` [G * 48, 8] in the order K6's
    tensor-core product reads it, int32 [G, 6, 32, 2]. Entry [g, q, lane]
    is the B fragment of n-tile q (quantity q of group g's 8 triangles) for
    that lane of an m16n8k16 product: triangle i = lane // 4, coefficients
    k = 2 * (lane % 4) and k + 1; word 0 their high parts, word 1 their low
    parts, two bf16 to a word with coefficient k in the low 16 bits.
    Coefficient 7 meets the ray's packed 0 and is stored as 0."""
    g = coeffs.shape[0] // rc._AROWS
    hi, lo = _split_bf16(coeffs.reshape(g, rc._NQ, rc._GROUP, 8))

    def words(x):  # [g, 6, 8, 8] f32 -> [g, 6, 32] int32, lane = 4i + t
        x = x.clone()
        x[..., 7] = 0.0
        return x.to(torch.bfloat16).contiguous().view(torch.int32).reshape(
            g, rc._NQ, 32)

    return torch.stack([words(hi), words(lo)], dim=-1).contiguous()


# Each coeffs tensor's B fragments with the tensor version they were made
# from: made once per scene, where the renderer keeps its packing.
_FRAGMENTS = WeakIdKeyDictionary()


def _fragments_of(coeffs: torch.Tensor) -> torch.Tensor:
    hit = _FRAGMENTS.get(coeffs)
    if hit is None or hit[0] != coeffs._version:
        hit = (coeffs._version, b_fragments(coeffs))
        _FRAGMENTS[coeffs] = hit
    return hit[1]


def products_high(state: torch.Tensor, coeffs: torch.Tensor
                  ) -> torch.Tensor:
    """The probe of K6's "high" product: [N, G, 6, 8] as
    :func:`products_plain`, for a CUDA tensor from the kernel's own code
    (its A fragments, B fragments and tensor-core products), for a CPU
    tensor from :func:`products_plain`."""
    global group_probe_launches
    if state.dim() != 2 or state.shape[0] < 16 \
            or state.dtype != torch.float32 or not state.is_contiguous():
        raise ValueError("state must be a contiguous float32 [ncols, N]")
    if coeffs.dim() != 2 or coeffs.shape[1] != 8 \
            or coeffs.shape[0] % rc._AROWS or coeffs.device != state.device:
        raise ValueError(f"coeffs must be [G * {rc._AROWS}, 8] on the "
                         f"state's device")
    if state.device.type == "cpu":
        return products_plain(state, coeffs)
    if state.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {state.device}")
    g = coeffs.shape[0] // rc._AROWS
    frags = _fragments_of(coeffs)
    out = torch.empty((state.shape[1], g, rc._NQ, rc._GROUP),
                      dtype=torch.float32, device=state.device)
    err = _build.library().ar2_group_probe(
        state.data_ptr(), state.shape[1], state.shape[0], frags.data_ptr(),
        g, out.data_ptr(), _build.stream(state.device))
    group_probe_launches += 1
    _build.check(err, "ar2_group_probe")
    return out


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
    high = precision == "high"
    table = _fragments_of(coeffs) if high else coeffs
    err = _build.library().ar2_trace_group(
        state.data_ptr(), state.shape[1], state.shape[0], table.data_ptr(),
        attrs.data_ptr(), coeffs.shape[0] // rc._AROWS, attrs.shape[1],
        scal.data_ptr(), n_poses, rays_per_pose, params.n_bands,
        rc.layout_bands(params.n_bands), int(round_budget),
        params.max_bounces, int(high), _build.stream(state.device))
    if scal.dim() == 2:
        trace_round_group_posed_launches += 1
    else:
        trace_round_group_launches += 1
    _build.check(err, "ar2_trace_group")
    return state
