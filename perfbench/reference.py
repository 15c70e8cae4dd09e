"""The benchmark's plain reference: scenes, directions, tracer, convolution.

Plain PyTorch, independent of the program under test: it imports nothing of
``audiorenderingv2_tpu_torch`` and takes nothing it made. It builds the
configurations' raw triangles, draws the ray directions from the same seeded
generators the benchmark hands to the program, traces them in float64
(``dtype`` may be lowered for the precision control) and auralizes the IR
with the reference system's overlap-add.

The physics is that of the reference system (sgrazi/AudioRenderingV2,
``devicePrograms.cu`` and ``AudioRenderer.cpp``), as its documented
semantics read:

* each ray carries ``base_power / (n_rays * sphere_volume)``;
* it bounces while ``dist < ir_seconds * 343 + 1``, its energy is above the
  threshold and it has made fewer than ``max_bounces`` bounces;
* the receiver is an analytic 1 m sphere; the first crossing ends the ray
  and deposits its energy times the chord through the sphere, at bin
  ``round(dist / 343 * sample_rate)`` of the ear whose head-local
  hemisphere was hit, and ``(1 - hrtf_absorption_rate)`` of it
  ``int(sample_rate * 0.00044)`` bins later in the other ear (in the same
  bin when that falls past the end);
* a ray that misses every triangle ends; a hit reflects it specularly,
  scales its energy by ``1 - absorption`` and moves it 1e-3 m along the new
  direction;
* the intersection is Möller-Trumbore against every triangle a ray's line
  can reach: triangles are grouped 64 at a time in mesh order and a group
  is tested only when the ray meets its bounding box, padded so that the
  culling never drops a hit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SPEED_OF_SOUND = 343.0
SPHERE_VOLUME = 4.18879020478
RECEIVER_RADIUS = 1.0
HEAD_DELAY_SECONDS = 0.00044
BOUNCE_EPSILON = 1e-3
T_MIN = 1e-4
GROUP = 64          # triangles of one culling group
BOX_PAD = 1e-3      # metres added to every side of a group's box
RAY_BLOCK = 1 << 15  # rays whose group boxes are tested at once
PAIR_BLOCK = 1 << 17  # (ray, group) pairs whose triangles are tested at once


# ----------------------------------------------------------------- scenes

def box_mesh(size) -> tuple[np.ndarray, np.ndarray]:
    """A closed axis-aligned box centred at the origin, two triangles a
    face with normals inward: (vertices [8, 3], triangles [12, 3])."""
    sx, sy, sz = [float(s) / 2.0 for s in size]
    verts = np.array([
        [-sx, -sy, -sz], [sx, -sy, -sz], [sx, sy, -sz], [-sx, sy, -sz],
        [-sx, -sy, sz], [sx, -sy, sz], [sx, sy, sz], [-sx, sy, sz],
    ], np.float32)
    tris = np.array([
        [0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6],
        [0, 4, 5], [0, 5, 1], [3, 2, 6], [3, 6, 7],
        [0, 3, 7], [0, 7, 4], [1, 5, 6], [1, 6, 2],
    ], np.int32)
    return verts, tris


def icosphere_mesh(radius: float, center, subdivisions: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """A subdivided icosahedron: 20 * 4**subdivisions triangles."""
    phi = (1.0 + math.sqrt(5.0)) / 2.0
    base = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [tuple(v) for v in base]
    mids: dict = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in mids:
            m = np.add(verts[i], verts[j]) / 2.0
            mids[key] = len(verts)
            verts.append(tuple(m / np.linalg.norm(m)))
        return mids[key]

    for _ in range(subdivisions):
        nxt = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nxt
    v = (np.asarray(verts, np.float32) * radius
         + np.asarray(center, np.float32))
    return v, np.asarray(faces, np.int32)


def office_mesh(spec: dict) -> tuple[np.ndarray, np.ndarray]:
    """A box room and a grid of icospheres at seeded heights: the large
    office of the reference system's benchmarks, about
    ``spec["n_triangles_target"]`` triangles."""
    room = [float(s) for s in spec["room"]]
    radius = float(spec["sphere_radius"])
    sub = int(spec["sphere_subdivisions"])
    per_sphere = 20 * 4 ** sub
    bv, bt = box_mesh(room)
    verts, tris, base = [bv], [bt], len(bv)
    rng = np.random.default_rng(int(spec["height_seed"]))
    k = max(1, (int(spec["n_triangles_target"]) - len(bt)) // per_sphere)
    side = int(np.ceil(np.sqrt(k)))
    i = 0
    for gx in range(side):
        for gz in range(side):
            if i >= k:
                break
            cx = -room[0] / 2 + (gx + 0.5) * room[0] / side
            cz = -room[2] / 2 + (gz + 0.5) * room[2] / side
            cy = rng.uniform(-room[1] / 2 + 1.5, room[1] / 2 - 1.5)
            sv, st = icosphere_mesh(radius, (cx, cy, cz), sub)
            verts.append(sv)
            tris.append(st + base)
            base += len(sv)
            i += 1
    return np.vstack(verts), np.vstack(tris)


def scene_mesh(spec: dict) -> tuple[np.ndarray, np.ndarray]:
    """The raw mesh of a configuration's ``scene`` entry."""
    if spec["kind"] == "box":
        return box_mesh(spec["size"])
    if spec["kind"] == "office":
        return office_mesh(spec)
    raise ValueError(f"unknown scene kind {spec['kind']!r}")


# ------------------------------------------------------------- directions

def fold_seed(seed: int, index: int) -> int:
    """``seed`` and ``index`` mixed by the splitmix64 finaliser into a
    63-bit seed (the pair seed of a source-listener matrix)."""
    mask = (1 << 64) - 1
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(index) + 1) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    z ^= z >> 31
    return z >> 1


def directions(n: int, generator: torch.Generator, device,
               dtype=torch.float64) -> torch.Tensor:
    """``n`` uniform unit directions [n, 3] from the float32 uniforms that
    ``generator`` gives for a ``[n, 2]`` draw, mapped in ``dtype`` as the
    reference system maps them: theta = 2 pi u0, cos(phi) = 2 u1 - 1."""
    u = torch.rand((n, 2), generator=generator, device=device,
                   dtype=torch.float32).to(dtype)
    theta = 2.0 * math.pi * u[:, 0]
    cos_phi = 2.0 * u[:, 1] - 1.0
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    return torch.stack([sin_phi * torch.cos(theta),
                        sin_phi * torch.sin(theta), cos_phi], dim=-1)


def generator_from_state(state: torch.Tensor, device) -> torch.Generator:
    """A generator on ``device`` set to a state read with ``get_state``."""
    gen = torch.Generator(device=device)
    gen.set_state(state)
    return gen


def generator_from_seed(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


# ----------------------------------------------------------------- tracer

class Geometry:
    """A mesh's triangles in ``dtype`` on ``device``, padded to whole
    groups of ``GROUP`` with degenerate triangles, and each group's box."""

    def __init__(self, vertices, triangles, absorption: float, device,
                 dtype=torch.float64):
        v = torch.as_tensor(np.asarray(vertices, np.float64))
        t = torch.as_tensor(np.asarray(triangles, np.int64))
        n = t.shape[0]
        pad = -n % GROUP
        v0, v1, v2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
        nrm = torch.linalg.cross(v1 - v0, v2 - v0)
        nrm = nrm / nrm.norm(dim=1, keepdim=True)
        lo = torch.minimum(torch.minimum(v0, v1), v2)
        hi = torch.maximum(torch.maximum(v0, v1), v2)
        if pad:
            z = torch.zeros((pad, 3), dtype=torch.float64)
            v0, v1, v2, nrm = [torch.cat([a, z]) for a in (v0, v1, v2, nrm)]
            lo = torch.cat([lo, torch.full((pad, 3), math.inf,
                                           dtype=torch.float64)])
            hi = torch.cat([hi, torch.full((pad, 3), -math.inf,
                                           dtype=torch.float64)])
        g = (n + pad) // GROUP
        self.n_triangles = n
        self.n_groups = g
        self.v0 = v0.to(device, dtype)
        self.e1 = (v1 - v0).to(device, dtype)
        self.e2 = (v2 - v0).to(device, dtype)
        self.normal = nrm.to(device, dtype)
        self.absorption = torch.full((n + pad,), float(absorption),
                                     dtype=dtype, device=device)
        self.box_lo = (lo.view(g, GROUP, 3).amin(1) - BOX_PAD).to(device,
                                                                  dtype)
        self.box_hi = (hi.view(g, GROUP, 3).amax(1) + BOX_PAD).to(device,
                                                                  dtype)


def _groups_reached(geo: Geometry, pos, d) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(ray, group) index pairs whose group box the ray's half-line meets."""
    rays, groups = [], []
    for s in range(0, pos.shape[0], RAY_BLOCK):
        o = pos[s:s + RAY_BLOCK, None, :]
        dd = d[s:s + RAY_BLOCK, None, :]
        inv = 1.0 / dd
        a = (geo.box_lo[None] - o) * inv
        b = (geo.box_hi[None] - o) * inv
        # A direction component of 0 gives +-inf, or nan inside the slab.
        a = torch.nan_to_num(a, nan=-math.inf)
        b = torch.nan_to_num(b, nan=math.inf)
        near = torch.minimum(a, b).amax(-1)
        far = torch.maximum(a, b).amin(-1)
        r, g = torch.nonzero((far >= near) & (far > 0.0), as_tuple=True)
        rays.append(r + s)
        groups.append(g)
    return torch.cat(rays), torch.cat(groups)


def nearest_hit(geo: Geometry, pos, d) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest triangle hit of every ray: (t [M], triangle [M]); t is inf
    and the triangle -1 where the ray hits nothing. Ties go to the lowest
    triangle index, as an argmin over all triangles gives."""
    m = pos.shape[0]
    dev, dt = pos.device, pos.dtype
    best_t = torch.full((m,), math.inf, dtype=dt, device=dev)
    best_i = torch.full((m,), -1, dtype=torch.int64, device=dev)
    if m == 0:
        return best_t, best_i
    ray, grp = _groups_reached(geo, pos, d)
    cand_t, cand_i, cand_r = [], [], []
    lane = torch.arange(GROUP, device=dev)
    for s in range(0, ray.shape[0], PAIR_BLOCK):
        r = ray[s:s + PAIR_BLOCK]
        tri = grp[s:s + PAIR_BLOCK, None] * GROUP + lane[None, :]
        o = pos[r][:, None, :]
        dd = d[r][:, None, :].expand(-1, GROUP, -1)
        e1, e2 = geo.e1[tri], geo.e2[tri]
        pvec = torch.linalg.cross(dd, e2)
        det = (e1 * pvec).sum(-1)
        ok = det.abs() > 1e-12
        inv_det = torch.where(ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
        tvec = o - geo.v0[tri]
        u = (tvec * pvec).sum(-1) * inv_det
        qvec = torch.linalg.cross(tvec, e1)
        v = (qvec * dd).sum(-1) * inv_det
        t = (e2 * qvec).sum(-1) * inv_det
        eps = 1e-7
        ok &= (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps) & (t > T_MIN)
        t = torch.where(ok, t, math.inf)
        k = torch.argmin(t, dim=1)
        cand_t.append(t.gather(1, k[:, None])[:, 0])
        cand_i.append(tri.gather(1, k[:, None])[:, 0])
        cand_r.append(r)
    ct, ci, cr = torch.cat(cand_t), torch.cat(cand_i), torch.cat(cand_r)
    best_t.scatter_reduce_(0, cr, ct, reduce="amin")
    hit = torch.isfinite(ct) & (ct == best_t[cr])
    big = torch.full_like(ci, 1 << 62)
    idx = torch.full((m,), 1 << 62, dtype=torch.int64, device=dev)
    idx.scatter_reduce_(0, cr, torch.where(hit, ci, big), reduce="amin")
    best_i = torch.where(torch.isfinite(best_t), idx, best_i)
    return best_t, best_i


def sphere_entry(pos, d, center) -> tuple[torch.Tensor, torch.Tensor]:
    """First crossing of the receiver sphere past T_MIN along each ray:
    (t, chord), t = inf where the sphere is missed."""
    oc = pos - center
    b = (oc * d).sum(-1)
    c = (oc * oc).sum(-1) - RECEIVER_RADIUS * RECEIVER_RADIUS
    disc = b * b - c
    s = torch.sqrt(torch.clamp(disc, min=0.0))
    t1, t2 = -b - s, -b + s
    t = torch.where(t1 > T_MIN, t1, torch.where(t2 > T_MIN, t2, math.inf))
    t = torch.where(disc > 0.0, t, math.inf)
    return t, t2 - t1


def trace_ir(geo: Geometry, dirs: torch.Tensor, emitter, receiver,
             yaw_deg: float, trace: dict, n_total: int | None = None,
             deposits: list | None = None) -> tuple[torch.Tensor, int]:
    """Trace ``dirs`` [N, 3] from ``emitter`` and bin the stereo IR.

    ``trace`` holds ``sample_rate``, ``ir_seconds``, ``base_power``,
    ``energy_threshold``, ``max_bounces``, ``hrtf_absorption_rate``.
    Returns (ir [2, ir_length] in the geometry's dtype, on its device; the
    number of ray-bounce steps taken, each of which tested the ray against
    every triangle). ``deposits``, when given, receives one tuple a bounce
    step of the receiver hits: (arrival distance, chord, bounces made, ear),
    before the cut at the IR's end."""
    dev, dt = dirs.device, dirs.dtype
    sr = int(trace["sample_rate"])
    ir_len = int(trace["ir_seconds"]) * sr
    n = dirs.shape[0]
    e0 = float(trace["base_power"]) / ((n_total or n) * SPHERE_VOLUME)
    dist_thresh = max(1, min(int(trace["ir_seconds"]), 999)) \
        * SPEED_OF_SOUND + 1.0
    delay = int(sr * HEAD_DELAY_SECONDS)
    keep_other = 1.0 - float(trace["hrtf_absorption_rate"])
    e_thr = float(trace["energy_threshold"])
    max_b = int(trace["max_bounces"])
    center = torch.as_tensor(np.asarray(receiver, np.float64)).to(dev, dt)
    theta = math.radians(float(yaw_deg))
    sin_t, cos_t = math.sin(theta), math.cos(theta)

    pos = torch.as_tensor(np.asarray(emitter, np.float64)).to(dev, dt) \
        .expand(n, 3).clone()
    d = dirs.clone()
    dist = torch.zeros(n, dtype=dt, device=dev)
    energy = torch.full((n,), e0, dtype=dt, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    ir = torch.zeros(2 * ir_len, dtype=dt, device=dev)
    live = torch.arange(n, device=dev)
    steps = 0
    while live.numel():
        p, dd = pos[live], d[live]
        t_tri, tri = nearest_hit(geo, p, dd)
        t_sph, chord = sphere_entry(p, dd, center)
        steps += live.numel()
        rec = t_sph < t_tri
        if bool(rec.any()):
            r = live[rec]
            ts = t_sph[rec]
            dist_hit = dist[r] + ts
            e_hit = energy[r] * chord[rec]
            q = p[rec] + ts[:, None] * dd[rec] - center
            ear = (-sin_t * q[:, 0] + cos_t * q[:, 2] >= 0.0).to(torch.int64)
            if deposits is not None:
                deposits.append((dist_hit, chord[rec], depth[r], ear))
            b = torch.round(dist_hit / SPEED_OF_SOUND * sr).to(torch.int64)
            inside = b < ir_len
            b, ear, e_hit = b[inside], ear[inside], e_hit[inside]
            cb = torch.where(b + delay < ir_len, b + delay, b)
            ir.index_add_(0, ear * ir_len + b, e_hit)
            ir.index_add_(0, (1 - ear) * ir_len + cb, e_hit * keep_other)
        go = ~rec & torch.isfinite(t_tri)
        r, t, k = live[go], t_tri[go], tri[go]
        hit_p = p[go] + t[:, None] * dd[go]
        nrm = geo.normal[k]
        nd = dd[go] - 2.0 * (dd[go] * nrm).sum(-1, keepdim=True) * nrm
        dist[r] = dist[r] + t
        energy[r] = energy[r] * (1.0 - geo.absorption[k])
        depth[r] = depth[r] + 1
        d[r] = nd
        pos[r] = hit_p + BOUNCE_EPSILON * nd
        alive = (dist[r] < dist_thresh) & (energy[r] > e_thr) \
            & (depth[r] < max_b)
        live = r[alive]
    return ir.view(2, ir_len), steps


# ------------------------------------------------------------ convolution

def overlap_add(samples: torch.Tensor, ir: torch.Tensor, sample_rate: int
                ) -> torch.Tensor:
    """The reference system's file convolution of ``samples`` [L] with
    ``ir`` [C, ir_length]: every whole 1 s segment zero-padded to
    ir_length and convolved circularly at that length, the results
    overlap-added, times 2 (its unnormalised FFT round trip over
    ir_length / 2), cut or zero-padded to L. [C, L] in ``ir``'s dtype."""
    dt = ir.dtype
    length = samples.shape[-1]
    n_ch, ir_len = ir.shape
    n_seg = length // sample_rate
    out = torch.zeros((n_ch, max(length, (n_seg + ir_len // sample_rate)
                                 * sample_rate)), dtype=dt, device=ir.device)
    if n_seg:
        segs = samples[:n_seg * sample_rate].to(dt).reshape(n_seg,
                                                            sample_rate)
        segs = torch.nn.functional.pad(segs, (0, ir_len - sample_rate))
        # FFTs run in float64 or float32; a lower precision rounds its
        # operands and its result to itself around a float32 transform.
        ft = dt if dt in (torch.float64, torch.float32) else torch.float32
        y = torch.fft.irfft(torch.fft.rfft(segs.to(ft))[None]
                            * torch.fft.rfft(ir.to(ft))[:, None],
                            n=ir_len).to(dt)
        for s in range(n_seg):
            a = s * sample_rate
            out[:, a:a + ir_len] += y[:, s]
    return out[:, :length] * 2.0



# ------------------------------------------------------------- the fit

def soft_ir(deposits: list, absorption: torch.Tensor, trace: dict,
            n_total: int) -> torch.Tensor:
    """The stereo IR of ``deposits`` (``trace_ir``'s) at a uniform
    ``absorption`` (a 0-d tensor, which may carry a gradient), each deposit
    spread linearly over the two bins around its arrival, its cross-ear
    share ``int(sample_rate * 0.00044)`` bins later (at the same arrival
    when the rounded delayed bin falls past the end); deposits outside the
    IR are dropped. [2, ir_length] in ``absorption``'s dtype."""
    dt, dev = absorption.dtype, absorption.device
    sr = int(trace["sample_rate"])
    nb = int(trace["ir_seconds"]) * sr
    dist = torch.cat([d[0] for d in deposits]).to(dt)
    chord = torch.cat([d[1] for d in deposits]).to(dt)
    depth = torch.cat([d[2] for d in deposits]).to(dt)
    ear = torch.cat([d[3] for d in deposits])
    e0 = float(trace["base_power"]) / (n_total * SPHERE_VOLUME)
    w = e0 * (1.0 - absorption) ** depth * chord
    bin_f = dist / SPEED_OF_SOUND * sr
    delay = int(sr * HEAD_DELAY_SECONDS)
    cross = torch.where(torch.round(bin_f) + delay >= nb, bin_f,
                        bin_f + delay)
    keep = 1.0 - float(trace["hrtf_absorption_rate"])
    parts = []
    for pos, weight, side in ((bin_f, w, ear), (cross, w * keep, 1 - ear)):
        b0 = torch.floor(pos)
        frac = pos - b0
        b0 = b0.to(torch.int64)
        for b, f in ((b0, 1.0 - frac), (b0 + 1, frac)):
            ok = (b >= 0) & (b < nb)
            parts.append((side[ok] * nb + b[ok], (weight * f)[ok]))
    idx = torch.cat([p[0] for p in parts])
    val = torch.cat([p[1] for p in parts])
    return torch.zeros(2 * nb, dtype=dt, device=dev).index_add(
        0, idx, val).view(2, nb)


def log_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mean((log(1 + 100 pred / max target) - log(1 + 100 target / max
    target))^2): the fit's loss, which weighs the tail against the early
    arrivals."""
    scale = torch.clamp(target.max(), min=1e-12)
    return torch.mean((torch.log1p(pred / scale * 100.0)
                       - torch.log1p(target / scale * 100.0)) ** 2)


def fit_steps(deposits: list, target: torch.Tensor, trace: dict,
              n_total: int, init_absorption: float, lr: float,
              steps: int) -> list:
    """Adam on the logit of a uniform absorption (absorption = its
    sigmoid), ``steps`` steps of the log loss of ``soft_ir`` against
    ``target``, in ``target``'s dtype: [(loss, gradient, logit after the
    step)] a step. Adam as Kingma and Ba state it, with bias correction,
    beta1 0.9, beta2 0.999 and eps 1e-8 outside the root."""
    a0 = float(init_absorption)
    theta = torch.tensor(math.log(a0 / (1.0 - a0)), dtype=target.dtype,
                         device=target.device)
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    out = []
    for t in range(1, steps + 1):
        th = theta.detach().requires_grad_(True)
        loss = log_loss(soft_ir(deposits, torch.sigmoid(th), trace,
                                n_total), target)
        (g,) = torch.autograd.grad(loss, th)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        m_hat = m / (1.0 - 0.9 ** t)
        v_hat = v / (1.0 - 0.999 ** t)
        theta = theta - lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
        out.append((float(loss.detach()), float(g), float(theta)))
    return out
