"""K1, the bounce round, and the loop of rounds around it.

The counterpart of ``audiorenderingv2_tpu/ops/raytrace_pallas.py`` together
with the packing of ``raytrace_pallas_v2.py``:

* ``pack_tris_rows``: the triangle rows K1 reads (``pack_tris_v2`` with
  ``layout="rows"``, trimmed at the last valid triangle);
  ``pack_tris_clusters``: the rows and boxes of a clustered scene (its
  cluster branch, trimmed to whole clusters); ``pack_tris_group``: the
  coefficient groups and attributes K6 reads (its ``layout="group"``,
  trimmed to whole groups of 8); ``pack_tris_v1``: the untrimmed [17, T]
  table K7 reads (``raytrace_pallas.py:pack_tris``); ``pack_scene`` picks
  one for a ``Route``, the kernels that ``core.tracer.trace_route``
  resolves from the options (its docstring holds the table);
* ``init_state``: the ray state, as ``[ncols, N]`` columns (structure of
  arrays: ray ``i`` of column ``c`` is ``state[c, i]``), with the column
  indices of the JAX package;
* ``trace_round``: K1. It launches ``csrc/trace_round.cu`` for a CUDA
  tensor, which replaces the TPU kernel
  ``raytrace_pallas_v2.py:_trace_round_kernel_v2`` (rows branch, launched by
  ``trace_round_v2``, :799), and runs the plain version,
  ``trace_round_plain``, for a CPU tensor. The TPU kernel steps 128-ray
  tiles in lockstep; the CUDA kernel gives each ray a thread that keeps its
  state in registers for the whole round and leaves when the ray is done.
  What bounds it on the card is FP32 throughput in the intersection loop and
  warp divergence, which the partition between rounds limits; triangle
  rows sit in shared memory. More in the source's header;
* ``trace_state``: every trace's rounds: one set-up of the rays
  and one loop of rounds (``_run_rounds``), each round the
  route's kernel and its reorder: an alive-first partition of the state,
  or on a clustered route a stable sort of the rays by dir72 coherence
  keys (``compaction_keys``: two launches of ``csrc/compaction_keys.cu``
  for a CUDA tensor, the plain ``_compaction_keys`` for a CPU tensor), so
  that the 128 rays of a tile share directions and cells and reach few
  clusters. ``trace_events`` returns its event slots;
* ``trace_events_pose_batch``: P poses in one launch per round (K1-pose,
  the TPU kernel's ``tiles_per_pose`` index map,
  ``raytrace_pallas_v2.py:887-904``, driven by
  ``raytrace_pallas.py:trace_events_pose_batch``). The state is pose-major,
  ``[ncols, P * n_pad]``; ``scal`` has one row per pose and each ray reads
  the row of its pose. The kernels are K1 and K2 themselves: one body, so
  the posed and the single-pose forms cannot drift apart. Between rounds
  the reorder runs per pose, so rays never move between poses;
* ``init_state_native``: K4, the initial state with directions generated in
  the kernel (``csrc/init_state.cu``, which replaces
  ``raytrace_pallas_v2.py:_init_state_kernel_v2``, launched by
  ``init_state_tiles``, :279), from a Philox4x32-10 stream keyed by (seed,
  global ray index); ``init_state_native_plain`` reproduces its integer
  words exactly. Bounded by the one write of the state.

Results do not depend on the schedule: every ray is independent, so round
budgets, the partition and the sort change only the speed. The budgets must
still sum to at least ``max_bounces``, or deep paths would be cut short.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, NamedTuple

import torch

from .. import constants
from ..core.params import TraceParams
from ..utils import profiling
from . import _build

if TYPE_CHECKING:
    from ..core.tracer import SceneArrays

# Kernel launches since import (or since a caller reset them to 0): K1 with
# one scalar row, K1 with a row per pose (``scal`` [P, 16]), and K4; and the
# calls of the key kernel, two launches each (bounds, keys).
launches = 0
posed_launches = 0
init_launches = 0
compaction_keys_launches = 0

_LANES = 128      # rays are padded to a multiple of this
_TRI_BLOCK = 16   # triangle rows are trimmed to whole blocks of this
_MAX_BANDS = 8
_NR = 24          # floats per triangle row: 16 fixed + up to 8 bands
_GROUP = 8        # triangles per group of the group layout
_NQ = 6           # its quantities per triangle: no, nd, ou, du, ov, dv
_AROWS = _NQ * _GROUP  # coefficient rows per group

# Triangle-row columns (raytrace_pallas_v2.py:60-63).
(_R_PNX, _R_PNY, _R_PNZ, _R_PD,
 _R_AUX, _R_AUY, _R_AUZ, _R_AUO,
 _R_AVX, _R_AVY, _R_AVZ, _R_AVO,
 _R_NX, _R_NY, _R_NZ, _R_VAL, _R_ABS) = range(17)

# Scalar slots (raytrace_pallas.py:61-63).
_NSCAL = 16
(_S_EMX, _S_EMY, _S_EMZ, _S_RCX, _S_RCY, _S_RCZ,
 _S_SINY, _S_COSY, _S_E0, _S_ETHR, _S_DTHR, _S_BINRATE,
 _S_R2, _S_BUDGET, _S_PAD14, _S_PAD15) = range(_NSCAL)

# Ray-state columns (raytrace_pallas.py:72-75). RAYID rides along
# untouched; LTRI = 1 + id of the triangle bounced off in the current round
# (0 = none); RECVD = bounce depth at which the receiver was entered.
(_C_PX, _C_PY, _C_PZ, _C_VX, _C_VY, _C_VZ,
 _C_DIST, _C_EN, _C_DEPTH, _C_DONE,
 _C_EVB, _C_EVW, _C_EVE, _C_RAYID, _C_LTRI, _C_RECVD) = range(16)


def layout_bands(n_bands: int) -> int:
    """Band capacity of the state layout (1, 4 or 8)."""
    if not 1 <= n_bands <= _MAX_BANDS:
        raise ValueError(f"the trace kernel supports 1 to {_MAX_BANDS} "
                         f"bands, got {n_bands}")
    return 1 if n_bands == 1 else (4 if n_bands <= 4 else 8)


def state_ncols(n_bands: int) -> int:
    """16 columns for one band; banded layouts add the extra energy and
    event-weight columns, rounded up to a multiple of 8."""
    lb = layout_bands(n_bands)
    return 16 + (-(-(2 * (lb - 1)) // 8)) * 8


def band_cols(n_bands: int) -> tuple[list[int], list[int]]:
    """State columns of the per-band energies and event weights: band 0 in
    EN/EVW, band b >= 1 at 16 + b - 1 and 16 + (layout_bands - 1) + b - 1."""
    lb = layout_bands(n_bands)
    en = [_C_EN] + [16 + b - 1 for b in range(1, n_bands)]
    evw = [_C_EVW] + [16 + (lb - 1) + b - 1 for b in range(1, n_bands)]
    return en, evw


def _absorption_columns(sc: SceneArrays, n_bands: int) -> list:
    """One absorption column [T] per band; only a one-band table
    broadcasts over the bands."""
    if n_bands > _MAX_BANDS:
        raise ValueError(f"the trace kernel supports at most {_MAX_BANDS} "
                         f"bands")
    absorb = sc.absorption
    if absorb.dim() == 1:
        absorb = absorb[:, None]
    if absorb.shape[1] not in (1, n_bands) and n_bands > absorb.shape[1]:
        raise ValueError(f"scene has {absorb.shape[1]} absorption bands "
                         f"but params ask for {n_bands}; only 1-band "
                         f"scenes broadcast")
    return [absorb[:, min(b, absorb.shape[1] - 1)] for b in range(n_bands)]


def _stack_rows(sc: SceneArrays, n_bands: int) -> torch.Tensor:
    """Untrimmed triangle rows f32 [T, 24]: plane (n, d), barycentric (a_u,
    u_off, a_v, v_off), unit normal, valid flag, then one absorption column
    per band."""
    ab_cols = _absorption_columns(sc, n_bands)
    t = sc.plane_n.shape[0]
    zeros = torch.zeros(t, dtype=torch.float32, device=sc.plane_n.device)
    return torch.stack([
        sc.plane_n[:, 0], sc.plane_n[:, 1], sc.plane_n[:, 2], sc.plane_d,
        sc.bary_u[:, 0], sc.bary_u[:, 1], sc.bary_u[:, 2], sc.u_off,
        sc.bary_v[:, 0], sc.bary_v[:, 1], sc.bary_v[:, 2], sc.v_off,
        sc.normal[:, 0], sc.normal[:, 1], sc.normal[:, 2], sc.valid,
        *ab_cols, *[zeros] * (_NR - 16 - n_bands),
    ], dim=1).to(torch.float32)


def _n_valid(sc: SceneArrays) -> int:
    """1 + index of the LAST valid triangle (0 if none): valid = 0 also
    marks interior degenerate faces, so a trim at the valid count would drop
    real tail triangles. Reads the flags back to the host."""
    valid_idx = torch.nonzero(sc.valid > 0)
    return int(valid_idx.max()) + 1 if valid_idx.numel() else 0


def pack_tris_rows(sc: SceneArrays, n_bands: int = 1) -> torch.Tensor:
    """Triangle rows f32 [T_trim, 24] (see ``_stack_rows``), trimmed to
    whole 16-row blocks past the last valid triangle."""
    rows = _stack_rows(sc, n_bands)
    keep = max(1, -(-_n_valid(sc) // _TRI_BLOCK)) * _TRI_BLOCK
    if keep < rows.shape[0]:
        rows = rows[:keep]
    if rows.shape[0] % _TRI_BLOCK:
        raise ValueError(f"{rows.shape[0]} triangle rows are not a multiple "
                         f"of {_TRI_BLOCK}")
    return rows.contiguous()


def pack_tris_clusters(sc: SceneArrays, n_bands: int = 1
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows f32 [C_trim * cs, 24] and boxes f32 [C_trim, 8] of a clustered
    scene, cs = T // C triangles per cluster. Trimmed to whole clusters past
    the last valid triangle, the boxes with them. Raises when cs does not
    divide T or is not a multiple of 16."""
    boxes = sc.cluster_boxes
    t, c = sc.plane_n.shape[0], boxes.shape[0]
    cs = t // c
    if cs * c != t or cs % _TRI_BLOCK:
        raise ValueError(f"clustered scene: {t} triangles over {c} clusters "
                         f"needs a cluster size that is a multiple of "
                         f"{_TRI_BLOCK}")
    rows = _stack_rows(sc, n_bands)
    keep = max(1, -(-_n_valid(sc) // cs))
    if keep < c:
        rows, boxes = rows[:keep * cs], boxes[:keep]
    return rows.contiguous(), boxes.to(torch.float32).contiguous()


def attr_cols(n_bands: int) -> int:
    """Columns of the group layout's attribute table: 3 normal + n_bands
    absorption + valid, rounded up to 8 or 16."""
    return 8 if n_bands <= 4 else 16


def pack_tris_group(sc: SceneArrays, n_bands: int = 1
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's operands (``pack_tris_v2`` with ``layout="group"``): ``coeffs``
    f32 [G * 48, 8] and ``attrs`` f32 [G * 8, 8 or 16], G groups of 8
    triangles, trimmed to whole groups past the last valid triangle.

    Row ``g * 48 + q * 8 + i`` of ``coeffs`` holds the 8 coefficients that
    give quantity q of triangle ``g * 8 + i`` as a product with the ray's
    (px, py, pz, vx, vy, vz, 1, 0):
      no = pn . p + pd     nd = pn . v
      ou = au . p + u_off  du = au . v
      ov = av . p + v_off  dv = av . v
    ``attrs`` rows: unit normal, ``n_bands`` absorptions, the valid flag at
    column 3 + n_bands, zeros. Raises for a triangle count that is not a
    multiple of 8, more than 8 bands, a band mismatch, and a clustered
    scene."""
    t = sc.plane_n.shape[0]
    if t % _GROUP:
        raise ValueError(f"triangle count {t} not a multiple of {_GROUP}")
    ab_cols = _absorption_columns(sc, n_bands)
    if sc.cluster_boxes is not None:
        raise ValueError("group layout cannot carry cluster boxes")
    zeros = torch.zeros(t, dtype=torch.float32, device=sc.plane_n.device)

    def coeff(vec3, offset, on_pos):
        x, y, z = vec3[:, 0], vec3[:, 1], vec3[:, 2]
        if on_pos:
            return torch.stack([x, y, z, zeros, zeros, zeros, offset, zeros],
                               dim=1)
        return torch.stack([zeros, zeros, zeros, x, y, z, zeros, zeros],
                           dim=1)

    q = torch.stack([
        coeff(sc.plane_n, sc.plane_d, True), coeff(sc.plane_n, zeros, False),
        coeff(sc.bary_u, sc.u_off, True), coeff(sc.bary_u, zeros, False),
        coeff(sc.bary_v, sc.v_off, True), coeff(sc.bary_v, zeros, False),
    ], dim=1)  # [T, 6 quantities, 8 coefficients]
    coeffs = q.reshape(t // _GROUP, _GROUP, _NQ, 8).permute(0, 2, 1, 3)
    coeffs = coeffs.reshape(t // _GROUP * _AROWS, 8).to(torch.float32)
    attrs = torch.stack([
        sc.normal[:, 0], sc.normal[:, 1], sc.normal[:, 2], *ab_cols,
        sc.valid, *[zeros] * (attr_cols(n_bands) - 4 - n_bands),
    ], dim=1).to(torch.float32)
    keep = max(1, -(-_n_valid(sc) // _GROUP))
    if keep < t // _GROUP:
        coeffs, attrs = coeffs[:keep * _AROWS], attrs[:keep * _GROUP]
    return coeffs.contiguous(), attrs.contiguous()


def pack_tris_v1(sc: SceneArrays) -> torch.Tensor:
    """K7's triangle table f32 [17, T] (``raytrace_pallas.py:pack_tris``):
    the rows of K1's layout as columns, with the absorption (row 15) before
    the valid flag (row 16). One band, no trim; T must be a multiple of
    128."""
    absorb = sc.absorption
    if absorb.dim() == 2 and absorb.shape[1] == 1:
        absorb = absorb[:, 0]
    if absorb.dim() != 1:
        raise ValueError(f"the version-1 kernel carries one absorption "
                         f"band, the scene has {absorb.shape[1]}")
    tris = torch.stack([
        sc.plane_n[:, 0], sc.plane_n[:, 1], sc.plane_n[:, 2], sc.plane_d,
        sc.bary_u[:, 0], sc.bary_u[:, 1], sc.bary_u[:, 2], sc.u_off,
        sc.bary_v[:, 0], sc.bary_v[:, 1], sc.bary_v[:, 2], sc.v_off,
        sc.normal[:, 0], sc.normal[:, 1], sc.normal[:, 2], absorb, sc.valid,
    ]).to(torch.float32)
    if tris.shape[1] % _LANES:
        raise ValueError(f"triangle count {tris.shape[1]} not a multiple of "
                         f"{_LANES}")
    return tris.contiguous()


class Route(NamedTuple):
    """The kernels of a trace, as ``core.tracer.trace_route`` resolves them
    from the options (its docstring holds the table). ``kernel``: the
    round's kernel, ``"k1"``, ``"k6"``, ``"k7"``, ``"sched"`` (the per-tile
    schedule, then K2) or ``"k5"``; ``reorder``: what follows it between
    rounds, ``"partition"`` (alive-first), ``"sort"`` (the dir72 keys) or
    None; ``precision``: K6's product. The properties say what the route
    can do."""

    kernel: str = "k1"
    reorder: str | None = "partition"
    precision: str = "highest"

    @property
    def clustered(self) -> bool:
        """Culls by the cluster boxes of a Morton-sorted scene."""
        return self.kernel in ("sched", "k5")

    @property
    def pose_batch(self) -> bool:
        """Has a posed form: P poses in one launch a round."""
        return self.kernel in ("k1", "k6", "sched")

    @property
    def k4(self) -> bool:
        """Can start from K4's state, its directions made in the kernel."""
        return self.kernel != "k7"

    @property
    def ray_dim(self) -> int:
        """The state's ray axis: 0 for K7's row-major [N, 16], else 1."""
        return 0 if self.kernel == "k7" else 1

    @property
    def one_bounce(self) -> bool:
        """Takes one bounce a round: the schedule is computed from the
        positions before the bounce."""
        return self.kernel == "sched"


ROWS = Route()  # K1 over the triangle rows, the alive-first partition


def pack_scene(sc: SceneArrays, n_bands: int = 1, route: Route | None = None):
    """(tris, boxes) for a trace of ``route``: K7's [17, T] table (it never
    culls: boxes None); K6's (coeffs, attrs), which a clustered scene
    refuses; else the rows, with the boxes when the scene has cluster
    boxes. None packs for K1 or, on a clustered scene, K2 and K5."""
    kernel = None if route is None else route.kernel
    if kernel == "k7":
        return pack_tris_v1(sc), None
    if kernel == "k6":
        return pack_tris_group(sc, n_bands), None
    if sc.cluster_boxes is not None:
        return pack_tris_clusters(sc, n_bands)
    return pack_tris_rows(sc, n_bands), None


def scalars(emitter: torch.Tensor, receiver_pos: torch.Tensor, yaw_deg,
            e0: float, params: TraceParams) -> torch.Tensor:
    """The f32 [16] scalar row both versions of K1 read, or [P, 16], one
    row per pose, for ``emitter`` and ``receiver_pos`` [P, 3] and
    ``yaw_deg`` [P]."""
    dev = emitter.device
    yaw_rad = torch.deg2rad(torch.as_tensor(yaw_deg, dtype=torch.float32,
                                            device=dev))
    vals = torch.zeros(emitter.shape[:-1] + (_NSCAL,), dtype=torch.float32,
                       device=dev)
    vals[..., _S_EMX:_S_EMZ + 1] = emitter
    vals[..., _S_RCX:_S_RCZ + 1] = receiver_pos
    vals[..., _S_SINY] = torch.sin(yaw_rad)
    vals[..., _S_COSY] = torch.cos(yaw_rad)
    vals[..., _S_E0] = e0
    vals[..., _S_ETHR] = params.energy_threshold
    vals[..., _S_DTHR] = params.distance_threshold
    vals[..., _S_BINRATE] = params.sample_rate / constants.SPEED_OF_SOUND
    vals[..., _S_R2] = constants.RECEIVER_RADIUS ** 2
    return vals


def init_state(directions: torch.Tensor, emitter: torch.Tensor, e0: float,
               n_pad: int, n_bands: int = 1) -> torch.Tensor:
    """The initial ray state f32 [ncols, n_pad] for ``directions`` [N, 3],
    or [ncols, P * n_pad], pose-major, for ``directions`` [P, N, 3] and
    ``emitter`` [P, 3]. Padding rays start done with zero energy."""
    lead, n = directions.shape[:-2], directions.shape[-2]
    state = torch.zeros((state_ncols(n_bands),) + lead + (n_pad,),
                        dtype=torch.float32, device=directions.device)
    state[_C_PX:_C_PZ + 1] = emitter.movedim(-1, 0)[..., None]
    state[_C_VX:_C_VZ + 1, ..., :n] = directions.movedim(-1, 0)
    for c in band_cols(n_bands)[0]:
        state[c, ..., :n] = e0
    state[_C_DONE, ..., n:] = 1.0
    return state.reshape(state.shape[0], -1)


# ------------------------------------------------------------- K4, plain

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo32(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * x for a 32-bit constant ``m`` and
    int64 ``x`` holding 32-bit values. The 64-bit product would overflow
    int64, so ``x`` is taken in 16-bit halves for the high word."""
    lo16 = m * (x & 0xFFFF)
    hi = (m * (x >> 16) + (lo16 >> 16)) >> 16
    return hi, (m * x) & _MASK32  # int64 products wrap; the low word holds


def philox4x32_10(counter: tuple, key: tuple) -> tuple:
    """Philox4x32-10 (Salmon et al., SC'11) in int64 tensor arithmetic:
    four counter words and two key words, each an int64 tensor (or int)
    holding a 32-bit value, to four output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _MASK32
        k1 = (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def native_words(seed: torch.Tensor, n_pad: int) -> torch.Tensor:
    """The two 32-bit words K4 draws for each ray, int64 [2, n_pad] on the
    seed's device: words 0 and 1 of Philox4x32-10 at counter (ray index
    low word, high word, 0, 0) and key (seed, 0)."""
    ray = torch.arange(n_pad, dtype=torch.int64, device=seed.device)
    w0, w1, _, _ = philox4x32_10((ray & _MASK32, ray >> 32, 0, 0),
                                 (seed.to(torch.int64) & _MASK32, 0))
    return torch.stack([w0, w1])


def init_state_native_plain(scal: torch.Tensor, n_pad: int, n_real: int,
                            n_bands: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K4: the initial state f32 [ncols, n_pad]
    with directions from the Philox stream of :func:`native_words`. The
    emitter, e0 and the seed are read from ``scal`` [16] (the seed from
    slot 14). Every column is written: RAYID = the ray index, RECVD = -1,
    padding rays done with zero energy but a direction like any other."""
    dev = scal.device
    words = native_words(scal[_S_PAD14].to(torch.int64), n_pad)
    u = (words >> 8).to(torch.float32) * (1.0 / (1 << 24))
    theta = 2.0 * math.pi * u[0]
    cos_phi = 2.0 * u[1] - 1.0
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    real = torch.arange(n_pad, device=dev) < n_real
    state = torch.zeros((state_ncols(n_bands), n_pad), dtype=torch.float32,
                        device=dev)
    state[_C_PX:_C_PZ + 1] = scal[_S_EMX:_S_EMZ + 1, None]
    state[_C_VX] = sin_phi * torch.cos(theta)
    state[_C_VY] = sin_phi * torch.sin(theta)
    state[_C_VZ] = cos_phi
    for c in band_cols(n_bands)[0]:
        state[c] = torch.where(real, scal[_S_E0], 0.0)
    state[_C_DONE] = (~real).to(torch.float32)
    state[_C_RAYID] = torch.arange(n_pad, device=dev).to(torch.float32)
    state[_C_RECVD] = -1.0
    return state


def init_state_native(scal: torch.Tensor, n_pad: int, n_real: int,
                      n_bands: int = 1) -> torch.Tensor:
    """K4: the initial ray state f32 [ncols, n_pad] on ``scal``'s device,
    directions generated per ray from the seed in ``scal[14]`` (an integer
    below 2^23, exact in f32). A CUDA tensor goes to ``csrc/init_state.cu``,
    a CPU tensor to :func:`init_state_native_plain`."""
    global init_launches
    if scal.dtype != torch.float32 or scal.shape != (_NSCAL,) \
            or not scal.is_contiguous():
        raise ValueError(f"scal must be contiguous float32 [{_NSCAL}], got "
                         f"{scal.dtype} {tuple(scal.shape)}")
    if not 0 <= n_real <= n_pad or n_pad < 1:
        raise ValueError(f"need 0 <= n_real <= n_pad and n_pad >= 1, got "
                         f"n_real={n_real}, n_pad={n_pad}")
    if scal.device.type == "cpu":
        return init_state_native_plain(scal, n_pad, n_real, n_bands)
    if scal.device.type != "cuda":
        raise ValueError(f"no init kernel for device {scal.device}")
    ncols = state_ncols(n_bands)
    state = torch.empty((ncols, n_pad), dtype=torch.float32,
                        device=scal.device)
    err = _build.library().ar2_init_state(
        state.data_ptr(), n_pad, ncols, n_real, scal.data_ptr(), n_bands,
        layout_bands(n_bands), _build.stream(scal.device))
    init_launches += 1
    _build.check(err, "ar2_init_state")
    return state


def _round_schedule(max_bounces: int, first: int = 6,
                    growth: int = 2) -> list[int]:
    """Geometric per-round bounce budgets summing to >= max_bounces; the
    last round absorbs a sub-geometric remainder (100 -> [6, 12, 24, 58])."""
    budgets = []
    total = 0
    b = first
    while total < max_bounces:
        remaining = max_bounces - total
        b = remaining if remaining <= b + b // 2 else min(b, remaining)
        budgets.append(b)
        total += b
        b *= growth
    return budgets


def _partition_alive_first(state: torch.Tensor, n_poses: int = 1,
                           ray_dim: int = 1) -> torch.Tensor:
    """Stable alive-first reorder of the rays, within each of the
    ``n_poses`` equal segments of the ray axis ``ray_dim`` (1 for the
    [ncols, N] state, 0 for K7's row-major [N, 16]). One cumsum over the whole
    ray axis, rebased at each pose's first ray, counts the alive rays up to
    each ray of its pose (the dead ones follow from the ray's position);
    that gives each ray its slot, a scatter inverts the slots into a
    permutation, and one ``index_select`` applies it. The alive rays, the
    next round's ``rays_alive``, are counted from the sum's last column."""
    n = state.shape[ray_dim]
    dev = state.device
    alive = (state.select(1 - ray_dim, _C_DONE) == 0.0).to(torch.int64)
    ca = torch.cumsum(alive, 0).view(n_poses, -1)
    alive = alive.view(n_poses, -1)
    ca = ca - (ca[:, :1] - alive[:, :1])          # restart at every pose
    within = torch.arange(alive.shape[1], device=dev)[None, :]
    cd = within + 1 - ca                          # dead rays up to here
    dest = torch.where(alive > 0, ca - 1, ca[:, -1:] + cd - 1)
    first = torch.arange(n_poses, device=dev)[:, None] * alive.shape[1]
    perm = torch.empty(n, dtype=torch.int64, device=dev).scatter_(
        0, (dest + first).reshape(-1), torch.arange(n, device=dev))
    profiling.count("rays_alive", lambda: ca[:, -1].sum())
    return state.index_select(ray_dim, perm)


# Coherence keys of the clustered route (raytrace_pallas.py:270-351, the
# JAX package's dir72 layout at its tuned cell_bits = 5).
CELL_BITS = 5


def _morton_interleave(cell: torch.Tensor, bits: int) -> torch.Tensor:
    """Interleave int32 per-axis cell coordinates [3, N] into Morton codes
    (3 * bits bits)."""
    code = torch.zeros_like(cell[0])
    for b in range(bits):
        for ax in range(3):
            code = code | (((cell[ax] >> b) & 1) << (3 * b + ax))
    return code


def _dominant_axis(av: torch.Tensor) -> torch.Tensor:
    """Index (0, 1, 2) of the largest of av [3, N], ties to the lower."""
    return torch.where((av[0] >= av[1]) & (av[0] >= av[2]), 0,
                       torch.where(av[1] >= av[2], 1, 2))


def _key_res(cell_bits: int) -> int:
    """Cells per axis of the key grid, 2^cell_bits; raises where the dir72
    keys would overflow int32."""
    res = 1 << cell_bits
    if 2 * 72 * res ** 3 > 1 << 31:
        raise ValueError(f"cell_bits={cell_bits} with dir72 keys overflows "
                         f"int32; use cell_bits <= 7")
    return res


def _compaction_keys(state: torch.Tensor, cell_bits: int = CELL_BITS,
                     n_poses: int = 1) -> torch.Tensor:
    """int32 sort keys [N], direction-major: the done flag, then 72
    direction bins (octant x dominant axis x second axis), then the Morton
    code of the ray's cell in a 2^cell_bits grid over the bounding box of
    ALL ray positions of the ray's pose, done ones included (``n_poses``
    equal segments of the ray axis, each with its own grid). The rays not
    done, the next round's ``rays_alive``, are counted from the done
    flags."""
    res = _key_res(cell_bits)
    done = state[_C_DONE].to(torch.int32)
    profiling.count("rays_alive", lambda: done.numel() - done.sum())
    p = state[_C_PX:_C_PZ + 1].view(3, n_poses, -1)
    v = state[_C_VX:_C_VZ + 1]
    pmin = p.amin(dim=2, keepdim=True)
    pmax = p.amax(dim=2, keepdim=True)
    scale = torch.tensor(res - 0.001, dtype=torch.float32, device=p.device)
    cell = torch.clamp(((p - pmin) / torch.clamp(pmax - pmin, min=1e-6)
                        * scale).to(torch.int32), 0, res - 1).view(3, -1)
    octant = ((v[0] > 0).to(torch.int32) * 4 + (v[1] > 0).to(torch.int32) * 2
              + (v[2] > 0).to(torch.int32))
    av = torch.abs(v)
    a0 = _dominant_axis(av)
    axis = torch.arange(3, device=v.device)[:, None]
    a1 = _dominant_axis(torch.where(axis == a0[None], -math.inf, av))
    dirbin = (octant * 9 + a0 * 3 + a1).to(torch.int32)
    return (done * (72 * res ** 3) + dirbin * res ** 3
            + _morton_interleave(cell, cell_bits))


_KEY_BOUNDS_RAYS = 2048  # rays a block of the key kernel's bounds pass
_KEY_BOUNDS_BLOCKS = 128  # at most, per pose


def compaction_keys(state: torch.Tensor, cell_bits: int = CELL_BITS,
                    n_poses: int = 1) -> torch.Tensor:
    """The dir72 sort keys of :func:`_compaction_keys`, int32 [N] on the
    state's device, for a contiguous float32 ``state`` [ncols, N] whose ray
    axis ``n_poses`` divides. A CUDA tensor goes to
    ``csrc/compaction_keys.cu`` (a bounds pass, then a key pass: two
    launches where the plain chain takes ~116), a CPU tensor to
    :func:`_compaction_keys`. The rays not done, the next round's
    ``rays_alive``, are counted from the done flags, as there."""
    global compaction_keys_launches
    if state.dtype != torch.float32 or state.dim() != 2 \
            or state.shape[0] < 16 or not state.is_contiguous():
        raise ValueError(f"state must be contiguous float32 [ncols >= 16, "
                         f"N], got {state.dtype} {tuple(state.shape)}"
                         f"{'' if state.is_contiguous() else ', strided'}")
    n = state.shape[1]
    if n_poses < 1 or n % n_poses:
        raise ValueError(f"{n_poses} poses do not divide {n} rays")
    _key_res(cell_bits)
    if state.device.type == "cpu":
        return _compaction_keys(state, cell_bits, n_poses)
    if state.device.type != "cuda":
        raise ValueError(f"no key kernel for device {state.device}")
    profiling.count("rays_alive", lambda: _n_alive(state))
    per_pose = n // n_poses
    n_blocks = min(_KEY_BOUNDS_BLOCKS, -(-per_pose // _KEY_BOUNDS_RAYS))
    partials = torch.empty((n_poses, 6, n_blocks), dtype=torch.float32,
                           device=state.device)
    keys = torch.empty((n,), dtype=torch.int32, device=state.device)
    err = _build.library().ar2_compaction_keys(
        state.data_ptr(), n, state.shape[0], n_poses, cell_bits,
        partials.data_ptr(), n_blocks, keys.data_ptr(),
        _build.stream(state.device))
    compaction_keys_launches += 1
    _build.check(err, "ar2_compaction_keys")
    return keys


def _sort_state_by_keys(state: torch.Tensor, keys: torch.Tensor,
                        n_poses: int = 1) -> torch.Tensor:
    """Stable sort of the ray columns by ``keys`` within each of the
    ``n_poses`` segments: the permutation from one key sort along the ray
    axis of a [P, n_pad] view, applied by one ``index_select``."""
    perm = torch.sort(keys.view(n_poses, -1), dim=1, stable=True).indices
    first = torch.arange(n_poses, device=keys.device)[:, None] \
        * perm.shape[1]
    return state.index_select(1, (perm + first).reshape(-1))


# ----------------------------------------------------------------- K1, plain

def _nearest_hit(px, py, pz, vx, vy, vz, tris: torch.Tensor,
                 chunk: int = 64):
    """Nearest valid triangle hit per ray: (t [k], index [k]); t = inf on a
    miss. Triangles are taken in chunks with a strict running minimum, so
    ties go to the lowest index, as in the TPU kernel."""
    k = px.shape[0]
    best_t = torch.full((k,), math.inf, dtype=torch.float32,
                        device=px.device)
    best_i = torch.zeros((k,), dtype=torch.int64, device=px.device)
    px, py, pz, vx, vy, vz = (a[None, :] for a in (px, py, pz, vx, vy, vz))
    for c0 in range(0, tris.shape[0], chunk):
        r = tris[c0:c0 + chunk]
        cr = lambda j: r[:, j:j + 1]  # noqa: E731  [c, 1]
        nd = vx * cr(_R_PNX) + vy * cr(_R_PNY) + vz * cr(_R_PNZ)
        no = px * cr(_R_PNX) + py * cr(_R_PNY) + pz * cr(_R_PNZ) + cr(_R_PD)
        safe = torch.abs(nd) > 1e-12
        t = -no / torch.where(safe, nd, 1.0)
        ou = px * cr(_R_AUX) + py * cr(_R_AUY) + pz * cr(_R_AUZ) + cr(_R_AUO)
        du = vx * cr(_R_AUX) + vy * cr(_R_AUY) + vz * cr(_R_AUZ)
        u = ou + t * du
        ov = px * cr(_R_AVX) + py * cr(_R_AVY) + pz * cr(_R_AVZ) + cr(_R_AVO)
        dv = vx * cr(_R_AVX) + vy * cr(_R_AVY) + vz * cr(_R_AVZ)
        v = ov + t * dv
        ok = (safe & (t > constants.T_MIN)
              & (u >= -1e-7) & (v >= -1e-7) & (u + v <= 1.0 + 1e-7)
              & (cr(_R_VAL) > 0))
        ct, ci = torch.where(ok, t, math.inf).min(dim=0)
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_i = torch.where(better, ci + c0, best_i)
    return best_t, best_i


def _can_continue(s: torch.Tensor, scal: torch.Tensor, en_cols: list[int],
                  max_bounces: int) -> torch.Tensor:
    """bool [k]: the rays of ``s`` [ncols, k] that may take another bounce
    (distance, energy of the strongest band, depth). ``scal`` is slot-major:
    ``scal[j]`` is slot j of every ray's row, [] or [k]."""
    e_max = s[en_cols[0]]
    for c in en_cols[1:]:
        e_max = torch.maximum(e_max, s[c])
    return ((s[_C_DIST] < scal[_S_DTHR]) & (e_max > scal[_S_ETHR])
            & (s[_C_DEPTH] < float(max_bounces)))


def _bounce(s: torch.Tensor, tris: torch.Tensor, scal: torch.Tensor,
            en_cols: list[int], evw_cols: list[int], max_bounces: int,
            best: tuple | None = None):
    """One bounce of the rays in ``s`` [ncols, k], in place. ``scal``: the
    scalar row [16] all rays share, or one row per ray [k, 16] (each ray's
    pose's). ``best``: the nearest hits (t [k], row index [k]) when the
    caller found them over a subset of ``tris``; None searches every row."""
    inf = math.inf
    scal = scal.movedim(-1, 0)  # slot j of every row: scal[j], [] or [k]
    px, py, pz, vx, vy, vz = (s[c] for c in range(_C_PX, _C_VZ + 1))
    dist, depth, done = s[_C_DIST], s[_C_DEPTH], s[_C_DONE]
    energy = [s[c] for c in en_cols]
    can_continue = _can_continue(s, scal, en_cols, max_bounces)
    alive = (done == 0.0) & can_continue

    if best is None:
        best = _nearest_hit(px, py, pz, vx, vy, vz, tris)
    best_t, best_i = best

    # receiver sphere, tested before the surface
    ocx = px - scal[_S_RCX]
    ocy = py - scal[_S_RCY]
    ocz = pz - scal[_S_RCZ]
    b = ocx * vx + ocy * vy + ocz * vz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - scal[_S_R2]
    disc = b * b - cc
    sph_hit = disc > 0.0
    sq = torch.sqrt(torch.where(sph_hit, disc, 0.0))
    t1 = -b - sq
    t2 = -b + sq
    t_sph = torch.where(sph_hit & (t1 > constants.T_MIN), t1,
                        torch.where(sph_hit & (t2 > constants.T_MIN), t2,
                                    inf))
    chord = t2 - t1  # also from inside the sphere
    receiver = alive & (t_sph < best_t)
    surface = alive & ~receiver & (best_t < inf)
    miss = alive & ~receiver & ~surface

    t_sph_safe = torch.where(t_sph < inf, t_sph, 0.0)
    dist_r = dist + t_sph_safe
    hx = px + t_sph_safe * vx - scal[_S_RCX]
    hz = pz + t_sph_safe * vz - scal[_S_RCZ]
    local_z = -scal[_S_SINY] * hx + scal[_S_COSY] * hz
    ear = (local_z >= 0.0).to(torch.float32)
    ev_bin = torch.where(receiver, dist_r * scal[_S_BINRATE], s[_C_EVB])
    ev_w = [torch.where(receiver, e * chord, s[c])
            for e, c in zip(energy, evw_cols)]
    ev_ear = torch.where(receiver, ear, s[_C_EVE])

    # surface bounce: reflect, absorb, offset
    t_hit = torch.where(best_t < inf, best_t, 0.0)
    row = tris[best_i]  # [k, 24]
    bnx, bny, bnz = row[:, _R_NX], row[:, _R_NY], row[:, _R_NZ]
    dn = vx * bnx + vy * bny + vz * bnz
    rx = vx - 2.0 * dn * bnx
    ry = vy - 2.0 * dn * bny
    rz = vz - 2.0 * dn * bnz
    eps = constants.BOUNCE_EPSILON
    new = {
        _C_PX: torch.where(surface, px + t_hit * vx + eps * rx, px),
        _C_PY: torch.where(surface, py + t_hit * vy + eps * ry, py),
        _C_PZ: torch.where(surface, pz + t_hit * vz + eps * rz, pz),
        _C_VX: torch.where(surface, rx, vx),
        _C_VY: torch.where(surface, ry, vy),
        _C_VZ: torch.where(surface, rz, vz),
        _C_DIST: torch.where(surface, dist + t_hit, dist),
        _C_EVB: ev_bin,
        _C_EVE: ev_ear,
        _C_LTRI: torch.where(surface, best_i.to(torch.float32) + 1.0,
                             s[_C_LTRI]),
        # depth before the increment: receiver rays are not surface rays
        _C_RECVD: torch.where(receiver, depth, s[_C_RECVD]),
        _C_DEPTH: torch.where(surface, depth + 1.0, depth),
        _C_DONE: torch.maximum(
            done, (receiver | miss | ~can_continue).to(torch.float32)),
    }
    for band, (ec, wc) in enumerate(zip(en_cols, evw_cols)):
        new[ec] = torch.where(surface,
                              energy[band] * (1.0 - row[:, _R_ABS + band]),
                              energy[band])
        new[wc] = ev_w[band]
    for c, val in new.items():
        s[c] = val


def pose_rows(scal: torch.Tensor, ray_idx: torch.Tensor,
              rays_per_pose: int | None) -> torch.Tensor:
    """The scalar rows the rays ``ray_idx`` read: ``scal`` itself when it is
    one row [16], else row ``ray // rays_per_pose`` of [P, 16] per ray."""
    if scal.dim() == 1:
        return scal
    return scal[ray_idx // rays_per_pose]


def trace_round_plain(state: torch.Tensor, tris: torch.Tensor,
                      scal: torch.Tensor, params: TraceParams,
                      round_budget: int,
                      rays_per_pose: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K1: advance every ray by up to
    ``round_budget`` bounces, in place. Each bounce gathers the rays that
    are not done yet, steps them, and scatters them back; done rays are
    untouched, as in the kernel. With ``scal`` [P, 16], ray ``i`` reads row
    ``i // rays_per_pose``."""
    en_cols, evw_cols = band_cols(params.n_bands)
    state[_C_LTRI] = 0.0
    for _ in range(round_budget):
        idx = torch.nonzero(state[_C_DONE] == 0.0).squeeze(1)
        if idx.numel() == 0:
            break
        s = state[:, idx]
        _bounce(s, tris, pose_rows(scal, idx, rays_per_pose), en_cols,
                evw_cols, params.max_bounces)
        state[:, idx] = s
    return state


def check_poses(state: torch.Tensor, scal: torch.Tensor,
                rays_per_pose: int | None) -> tuple[int, int]:
    """(n_poses, rays_per_pose) of a launch, checked: ``scal`` is [16] (one
    pose over the whole state) or [P, 16] with ``rays_per_pose`` rays each,
    P * rays_per_pose = N, and rays_per_pose a multiple of 128 when P > 1,
    so that a 128-ray block never spans two poses."""
    n = state.shape[1]
    if scal.dim() not in (1, 2) or scal.shape[-1] != _NSCAL:
        raise ValueError(f"scal must be [{_NSCAL}] or [P, {_NSCAL}], got "
                         f"{tuple(scal.shape)}")
    n_poses = 1 if scal.dim() == 1 else scal.shape[0]
    if rays_per_pose is None:
        rays_per_pose = n // max(n_poses, 1)
    if n_poses < 1 or n_poses * rays_per_pose != n:
        raise ValueError(f"{n_poses} pose(s) of {rays_per_pose} rays do not "
                         f"make the state's {n} rays")
    if n_poses > 1 and rays_per_pose % _LANES:
        raise ValueError(f"rays_per_pose must be a multiple of {_LANES}, "
                         f"got {rays_per_pose}")
    return n_poses, int(rays_per_pose)


def _check_round(state, tris, scal, n_bands, round_budget) -> None:
    for name, x in (("state", state), ("tris", tris), ("scal", scal)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{x.dtype}")
        if x.device != state.device:
            raise ValueError(f"{name} on {x.device}, state on "
                             f"{state.device}")
    if state.dim() != 2 or state.shape[0] != state_ncols(n_bands):
        raise ValueError(f"state must be [{state_ncols(n_bands)}, N] for "
                         f"{n_bands} band(s), got {tuple(state.shape)}")
    if tris.dim() != 2 or tris.shape[1] != _NR:
        raise ValueError(f"tris must be [T, {_NR}], got {tuple(tris.shape)}")
    if int(round_budget) < 1:
        raise ValueError(f"round budget must be >= 1, got {round_budget}")


K1_CHUNK_ROWS = 512  # rows K1 stages at once (kChunk, csrc/trace_round.cu)


def k1_branch(n_rows: int) -> str:
    """The branch of ``csrc/trace_round.cu`` that ``n_rows`` triangle rows
    take: ``"one_chunk"`` up to K1_CHUNK_ROWS rows, every scene of the rows
    route (the rows staged once a block; a lane whose ray ends takes the
    warp's next one, on a persistent grid in rounds of more than 32
    bounces); ``"multi_chunk"`` above (the rows staged in chunks, blocks
    in step)."""
    if n_rows < 0:
        raise ValueError(f"a row count is >= 0, got {n_rows}")
    return "one_chunk" if n_rows <= K1_CHUNK_ROWS else "multi_chunk"


def trace_round(state: torch.Tensor, tris: torch.Tensor, scal: torch.Tensor,
                params: TraceParams, round_budget: int,
                rays_per_pose: int | None = None) -> torch.Tensor:
    """K1: advance every ray of ``state`` [ncols, N] by up to
    ``round_budget`` bounces, in place; returns ``state``. ``scal`` is one
    scalar row [16], or [P, 16] for a pose-major state of P poses with
    ``rays_per_pose`` rays each (K1-pose). A CUDA tensor goes to the
    kernel's branch for ``tris``' row count (:func:`k1_branch`), a CPU
    tensor to :func:`trace_round_plain`."""
    global launches, posed_launches
    _check_round(state, tris, scal, params.n_bands, round_budget)
    n_poses, rays_per_pose = check_poses(state, scal, rays_per_pose)
    if state.device.type == "cpu":
        return trace_round_plain(state, tris, scal, params,
                                 int(round_budget), rays_per_pose)
    if state.device.type != "cuda":
        raise ValueError(f"no trace kernel for device {state.device}")
    err = _build.library().ar2_trace_round(
        state.data_ptr(), state.shape[1], state.shape[0], tris.data_ptr(),
        tris.shape[0], scal.data_ptr(), n_poses, rays_per_pose,
        params.n_bands, layout_bands(params.n_bands), int(round_budget),
        params.max_bounces, _build.stream(state.device))
    if scal.dim() == 2:
        posed_launches += 1
    else:
        launches += 1
    _build.check(err, "ar2_trace_round")
    return state


# ------------------------------------------------------- the loop of rounds

def _budgets(params: TraceParams, round_budgets: tuple | None,
             route: Route) -> list[int]:
    """The per-round bounce budgets of a trace, checked. Only the schedule
    route is held to one bounce per round: K5 finds its clusters inside
    each bounce."""
    if round_budgets is not None:
        if sum(round_budgets) < params.max_bounces:
            raise ValueError(
                f"round_budgets {round_budgets} sum to "
                f"{sum(round_budgets)} < max_bounces {params.max_bounces}; "
                f"deep paths would be truncated")
        budgets = list(round_budgets)
    elif route.reorder is None:
        budgets = [params.max_bounces]
    elif route.clustered:
        budgets = [1] * params.max_bounces
    else:
        budgets = _round_schedule(params.max_bounces)
    if route.one_bounce and any(b != 1 for b in budgets):
        raise ValueError(f"the clustered route takes one bounce per round, "
                         f"got budgets {budgets}: positions move after a "
                         f"bounce, staling the schedule")
    return budgets


def _n_alive(state: torch.Tensor, ray_dim: int = 1) -> torch.Tensor:
    """The rays of ``state`` not done, a 0-dim tensor on its device."""
    return (state.select(1 - ray_dim, _C_DONE) == 0.0).sum()


def _run_rounds(state: torch.Tensor, tris, boxes: torch.Tensor | None,
                scal: torch.Tensor, params: TraceParams, budgets: list[int],
                route: Route, n_poses: int, n_rays: int,
                harvest=None) -> torch.Tensor:
    """The loop of rounds over ``state`` (rays along ``route.ray_dim``,
    ``n_poses`` equal segments) with the route's reorder between rounds
    kept inside each pose's segment. ``tris``: the pack of
    :func:`pack_scene` for the route. ``harvest``, when given, is called
    with the round's index and the state after every round's kernel,
    before the reorder.

    Each round is an ``ar2.trace.round`` span around its phases' spans
    (``ar2.trace.schedule``, ``ar2.trace.kernel``, then
    ``ar2.trace.partition`` or ``ar2.trace.keys`` and ``ar2.trace.sort``).
    Counted a round (``profiling.count``): ``rays_alive``, the rays not done
    at its start (for the first ``n_rays``, the rays launched; the reorder
    counts them for the next), and on the schedule route
    ``sched_candidates``, the tiles' reachable clusters summed, with
    ``n_tiles`` once, and ``sched_warp_visits``, the (warp, candidate)
    pairs whose rows K2 tested: one tensor of a row a round is zeroed
    before the rounds and summed after them, and only while counting."""
    # they build on this module
    from . import group_cuda, schedule_cuda, traverse_cuda, v1_cuda

    span, count = profiling.span, profiling.count
    kernel, ray_dim = route.kernel, route.ray_dim
    rays_per_pose = state.shape[ray_dim] // n_poses
    visits = None
    if kernel == "sched" and profiling.counting():
        visits = torch.zeros((len(budgets), state.shape[1] // _LANES),
                             dtype=torch.int32, device=state.device)
    for k, budget in enumerate(budgets):
        with span("ar2.trace.round"):
            if k == 0:
                count("rays_alive", lambda: n_rays)
            elif route.reorder is None:
                count("rays_alive", lambda: _n_alive(state, ray_dim))
            if kernel == "sched":
                with span("ar2.trace.schedule"):
                    sched = schedule_cuda.tile_schedule(state, boxes)
                count("sched_candidates", lambda: sched[:, 0].sum())
                count("n_tiles", lambda: sched.shape[0], once=True)
            with span("ar2.trace.kernel"):
                if kernel == "k1":
                    state = trace_round(state, tris, scal, params, budget,
                                        rays_per_pose)
                elif kernel == "k6":
                    state = group_cuda.trace_round_group(
                        state, *tris, scal, params, budget, rays_per_pose,
                        route.precision)
                elif kernel == "k7":
                    state = v1_cuda.trace_round_v1(state, tris, scal, params,
                                                   budget)
                elif kernel == "sched":
                    state = schedule_cuda.trace_round_sched(
                        state, tris, boxes, sched, scal, params,
                        rays_per_pose, None if visits is None else visits[k])
                else:
                    state = traverse_cuda.trace_traverse(
                        state, tris, boxes, scal, params, budget,
                        rays_per_pose)
            if harvest is not None:
                harvest(k, state)
            if k + 1 == len(budgets):
                break
            if route.reorder == "partition":
                with span("ar2.trace.partition"):
                    state = _partition_alive_first(state, n_poses, ray_dim)
            elif route.reorder == "sort":
                with span("ar2.trace.keys"):
                    keys = compaction_keys(state, n_poses=n_poses)
                with span("ar2.trace.sort"):
                    state = _sort_state_by_keys(state, keys, n_poses)
    if visits is not None:
        profiling.count_each("sched_warp_visits", lambda: visits.sum(dim=1))
    return state


def trace_state(tris, directions: torch.Tensor | None,
                emitters: torch.Tensor, receivers: torch.Tensor, yaws,
                params: TraceParams, *, route: Route = ROWS,
                boxes: torch.Tensor | None = None,
                n_total_rays: int | None = None,
                round_budgets: tuple | None = None,
                n_rays: int | None = None,
                native_rng_seed: torch.Tensor | None = None,
                harvest=None, record: bool = False) -> torch.Tensor:
    """Every trace's rounds: set the rays up, run the rounds of
    ``route`` and return the final state, [ncols, P * n_pad] (for K7 a
    view of its row-major state).

    ``directions`` [N, 3] with ``emitters``, ``receivers`` [3] and one yaw,
    or [P, N, 3] with [P, 3], [P, 3] and [P] for P poses, pose-major; None
    makes K4 generate ``n_rays`` directions from ``native_rng_seed``, a
    0-dim integer tensor below 2^23 on the device. ``tris``, ``boxes``:
    from :func:`pack_scene` for ``route``; boxes go with a clustered route
    and only with one. ``n_total_rays``: the ray count that normalises the
    per-ray energy when this call traces a share of a larger launch.
    ``round_budgets``: explicit per-round budgets (they must sum to at
    least ``max_bounces``; the schedule route takes only ones); by default
    a geometric schedule, one bounce per round on a clustered route, or
    one round without a reorder. For the path recorder, ``harvest`` (see
    :func:`_run_rounds`), and ``record``, which starts the recording
    columns: RAYID the launch index, RECVD -1."""
    if directions is None and (not route.k4 or native_rng_seed is None
                               or n_rays is None):
        raise ValueError("directions=None needs version=2 + "
                         "native_rng_seed + n_rays")
    if (boxes is not None) != route.clustered:
        raise ValueError("group layout cannot carry cluster boxes"
                         if route.kernel == "k6" else
                         "a clustered scene needs its packed boxes, and an "
                         "unclustered one none")
    budgets = _budgets(params, round_budgets, route)
    # The set-up: whole 128-ray tiles, the per-ray energy, the scalar
    # row(s), the initial state in the route's layout.
    lead = () if directions is None else directions.shape[:-2]
    n = int(n_rays) if directions is None else directions.shape[-2]
    n_pad = -(-n // _LANES) * _LANES
    e0 = params.base_power / ((n_total_rays if n_total_rays is not None
                               else n) * constants.SPHERE_VOLUME)
    n_poses = math.prod(lead)
    profiling.count("n_rays", lambda: n_poses * n, once=True)
    with profiling.span("ar2.trace.init"):
        scal = scalars(emitters, receivers, yaws, e0, params)
        if directions is None:
            seeded = scal.clone()
            seeded[_S_PAD14] = native_rng_seed.to(torch.float32)
            state = init_state_native(seeded, n_pad, n, params.n_bands)
        else:
            state = init_state(directions, emitters, e0, n_pad,
                               params.n_bands)
        if record:
            state[_C_RAYID] = torch.arange(
                n_pad, device=state.device).to(torch.float32)
            state[_C_RECVD] = -1.0
        if route.ray_dim == 0:
            state = state.T.contiguous()
    state = _run_rounds(state, tris, boxes, scal, params, budgets, route,
                        n_poses, n_poses * n, harvest=harvest)
    return state.T if route.ray_dim == 0 else state


def _event_weights(state: torch.Tensor, n_bands: int) -> torch.Tensor:
    """The event-weight rows of ``state`` [ncols, ...], band-major: for one
    band a view of its row (the events' weights need no copy), else the
    band columns gathered."""
    if n_bands == 1:
        return state[_C_EVW:_C_EVW + 1]
    return state[band_cols(n_bands)[1]]


def trace_events(tris, directions: torch.Tensor | None,
                 emitter: torch.Tensor, receiver_pos: torch.Tensor,
                 receiver_yaw_deg, params: TraceParams,
                 n_total_rays: int | None = None, *,
                 return_depth: bool = False, **kw):
    """Trace ``directions`` [N, 3] (or K4's ``n_rays``) in bounce rounds:
    :func:`trace_state`, whose keywords ``kw`` holds (``route``,
    ``boxes``, ``round_budgets``, ``n_rays``, ``native_rng_seed``).

    Returns the event slots (ev_bin_f f32 [n_pad], ev_w f32 [n_pad,
    n_bands], ev_ear int32 [n_pad]); padding rays carry zero weight. With
    ``return_depth`` also the final state's depth row, f32 [n_pad]: each
    ray's completed bounces, in the order of the other slots.
    """
    state = trace_state(tris, directions, emitter, receiver_pos,
                        receiver_yaw_deg, params, n_total_rays=n_total_rays,
                        **kw)
    events = (state[_C_EVB].contiguous(),
              _event_weights(state, params.n_bands).T.contiguous(),
              state[_C_EVE].to(torch.int32))
    return events + (state[_C_DEPTH].clone(),) if return_depth else events


def trace_events_pose_batch(tris, directions: torch.Tensor,
                            emitters: torch.Tensor, receivers: torch.Tensor,
                            receiver_yaws_deg: torch.Tensor,
                            params: TraceParams,
                            n_total_rays_per_pose: int | None = None, *,
                            route: Route = ROWS, **kw):
    """Trace P poses in one kernel launch per round.

    ``directions`` [P, N, 3], ``emitters`` and ``receivers`` [P, 3],
    ``receiver_yaws_deg`` [P]; ``n_total_rays_per_pose`` normalises each
    pose's energy (default N); ``route`` and the keywords ``kw`` holds
    (``boxes``, ``round_budgets``) as in :func:`trace_state`. The ray state
    is pose-major, [ncols, P * n_pad]: each 128-ray tile belongs to one
    pose and the kernels read that pose's scalar row; the reorder runs
    within each pose's segment. Pose ``p``'s events equal a
    :func:`trace_events` of its directions bit for bit.

    Returns (ev_bin_f f32 [P, n_pad], ev_w f32 [P, n_pad, n_bands], ev_ear
    int32 [P, n_pad]).
    """
    if not route.pose_batch:
        raise ValueError("pose-batched tracing on clustered scenes requires "
                         "schedule=True" if route.clustered else
                         f"the {route.kernel} route has no posed form")
    state = trace_state(tris, directions, emitters, receivers,
                        receiver_yaws_deg, params, route=route,
                        n_total_rays=n_total_rays_per_pose, **kw)
    state = state.view(state.shape[0], directions.shape[0], -1)
    return (state[_C_EVB].contiguous(),
            _event_weights(state, params.n_bands).permute(1, 2, 0)
            .contiguous(),
            state[_C_EVE].to(torch.int32))
