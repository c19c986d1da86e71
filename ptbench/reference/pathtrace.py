"""The plain path tracer: camera rays, the uniform stream, every bounce's
nearest hit and shading, and the accumulated image.

Shading is the upstream ``shadeRayKernel`` (``Renderer.cpp:411-479``) with
its quirks (parity mode): a hit on a DIFFUSE, METAL, COAT or REFLECTIVE
surface scatters (``utility.h:91-170``) from ``hit + 0.1 n`` and multiplies
the throughput by the material colour; EMISSIVE multiplies and ends the
path; a miss multiplies by 0.01 and ends it; SPECULAR and REFRACTIVE only
spend a bounce.  The image is the mean over samples of ``sqrt(max(colour,
0))`` (``Renderer.cpp:481-496``).  The primary hits are traced once and
shared by the samples (the upstream first-hit cache,
``Renderer.cpp:594-613``).
"""

from __future__ import annotations

import math

import torch

from . import rng
from .tracer import F_MAX, count_pairs, nearest_hit, operands
from .world import World, cross, dot, normalize

TWO_PI = 6.2831853071795864769252867665590057683943
SQRT13 = 0.5773502691896257645091487805019574556476
SPAWN = 0.1  # Renderer.cpp:437
MISS = 0.01  # Renderer.cpp:423
DIFFUSE, REFLECTIVE, EMISSIVE, COAT, METAL = 0, 2, 4, 5, 6


def camera_rays(camera: dict, resolution, device, dtype=torch.float32):
    """One ray per pixel through the image plane (``Renderer.cpp:521-555``),
    row 0 at the bottom: (origins (N, 3), unit directions (N, 3))."""
    w, h = resolution
    i = torch.arange(w * h, dtype=torch.int32, device=device)
    x0, x1 = camera["plane_x"]
    y0, y1 = camera["plane_y"]
    px = x0 + (i % w).to(dtype) * ((x1 - x0) / w)
    py = y0 + (i // w).to(dtype) * ((y1 - y0) / h)
    pz = torch.full((w * h,), camera["plane_z"], dtype=dtype, device=device)
    eye = torch.tensor(camera["position"], dtype=dtype, device=device)
    return eye.expand(w * h, 3), normalize(torch.stack([px, py, pz], dim=-1) - eye)


def _axis(like, k):
    e = torch.zeros_like(like)
    e[..., k] = 1.0
    return e


def _hemisphere(n, u0, u1):
    up = torch.sqrt(torch.clamp(u0, min=0.0))
    over = torch.sqrt(torch.clamp(1.0 - up * up, min=0.0))
    around = u1 * TWO_PI
    seed = torch.where((n[:, 0].abs() < SQRT13)[:, None], _axis(n, 0),
                       torch.where((n[:, 1].abs() < SQRT13)[:, None], _axis(n, 1), _axis(n, 2)))
    t1 = normalize(cross(n, seed))
    t2 = normalize(cross(n, t1))
    return (up[:, None] * n + (torch.cos(around) * over)[:, None] * t1
            + (torch.sin(around) * over)[:, None] * t2)


def _metal(n, d, u2, u3):
    phi = TWO_PI * u2
    cos_t = torch.pow(torch.clamp(1.0 - u3, min=0.0), 1.0 / 31.0)  # Phong exponent 30
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    w = normalize(d - n * (2.0 * dot(n, d)[:, None]))
    seed = torch.where((w[:, 0].abs() > 0.1)[:, None], _axis(w, 1), _axis(w, 0))
    u = normalize(cross(seed, w))
    v = cross(w, u)
    return (u * (torch.cos(phi) * sin_t)[:, None] + v * (torch.sin(phi) * sin_t)[:, None]
            + w * cos_t[:, None])


def _mirror(d, n):
    """The upstream ``reflectRay`` (``utility.h:64-69``): ``n - 2 (d . n) n``."""
    return n - 2.0 * dot(d, n)[:, None] * n


def shade(world: World, state, t, tri, u):
    """One shading step of every ray; ``state`` is (orig, dir, colour,
    remaining) and is returned advanced."""
    orig, dirn, color, remaining = state
    alive = remaining > 0
    hit = t < F_MAX
    k = tri.clamp(min=0)
    unit_z = _axis(orig, 2)
    n = torch.where(hit[:, None], world.shade_n[k], unit_z)
    mt = torch.where(hit, world.mat_type[k], 0)
    d = normalize(dirn)
    spawn = (orig + d * t[:, None]) + SPAWN * n
    is_d, is_m, is_c = mt == DIFFUSE, mt == METAL, mt == COAT
    is_r, is_e = mt == REFLECTIVE, mt == EMISSIVE
    mirror = _mirror(d, n)
    coat = torch.where((u[:, 0] < 0.5)[:, None], mirror, _hemisphere(n, u[:, 1], u[:, 2]))
    new_dir = torch.where(is_d[:, None], _hemisphere(n, u[:, 0], u[:, 1]),
                          torch.where(is_m[:, None], _metal(n, d, u[:, 2], u[:, 3]),
                                      torch.where(is_c[:, None], coat, mirror)))
    scatters = is_d | is_m | is_c | is_r
    shaded = alive & hit
    moved = (shaded & scatters)[:, None]
    tinted = (shaded & (scatters | is_e))[:, None]
    missed = alive & ~hit
    orig = torch.where(moved, spawn, orig)
    dirn = torch.where(moved, new_dir, dirn)
    color = torch.where(tinted, color * world.mat_color[world.model[k]], color)
    color = torch.where(missed[:, None], color * MISS, color)
    kill = missed | (shaded & is_e)
    remaining = torch.where(kill, 0, torch.where(alive, remaining - 1, remaining))
    return orig, dirn, color, remaining


def render(world: World, camera: dict, resolution, spp: int, bounces: int, seed: int,
           dtype=torch.float32, record: bool = False, count_every: int = 0):
    """The image of ``spp`` samples of ``bounces`` bounces under ``seed``.

    Returns ``(image (N, 3), topology, counts)``.  With ``record``,
    ``topology`` is a list of one (N, bounces) int64 tensor a sample: the
    triangle each bounce shaded, -1 where the ray was dead or missed.  With
    ``count_every = k > 0``, ``counts`` holds the work an exact tracer
    does, from every k-th ray of each wavefront, scaled by k: ``rays``,
    ``samples``, ``primary_pairs`` (the primary trace, once a frame),
    ``live`` and ``pairs`` per bounce summed over samples (bounce 0's
    pairs are the primary trace's, so ``pairs[0]`` is 0)."""
    device = world.a.device
    ops = operands(world)
    ro, rd = camera_rays(camera, resolution, device, dtype)
    n = ro.shape[0]
    ray = torch.arange(n, dtype=torch.int64, device=device)
    t0, tri0 = nearest_hit(ops, ro, rd)
    counts = None
    if count_every:
        sub = slice(None, None, count_every)
        counts = {"rays": n, "samples": spp, "live": [0] * bounces, "pairs": [0] * bounces,
                  "primary_pairs": int(count_pairs(ops, ro[sub], rd[sub], t0[sub]).sum())
                  * count_every}
    acc = torch.zeros((n, 3), dtype=dtype, device=device)
    topology = []
    for s in range(spp):
        state = (ro, rd, torch.ones((n, 3), dtype=dtype, device=device),
                 torch.full((n,), bounces, dtype=torch.int64, device=device))
        cols = []
        for b in range(bounces):
            live = state[3] > 0
            if b == 0:
                t, tri = t0, tri0
            else:
                idx = torch.nonzero(live).squeeze(1)
                o_l, d_l = state[0][idx], normalize(state[1][idx])
                t_l, tri_l = nearest_hit(ops, o_l, d_l)
                t = torch.full((n,), F_MAX, dtype=dtype, device=device).index_put((idx,), t_l)
                tri = torch.full((n,), -1, dtype=torch.int64, device=device).index_put(
                    (idx,), tri_l)
                if count_every:
                    sub = slice(None, None, count_every)
                    counts["pairs"][b] += int(
                        count_pairs(ops, o_l[sub], d_l[sub], t_l[sub]).sum()) * count_every
            if count_every:
                counts["live"][b] += int(live.sum())
            if record:
                cols.append(torch.where(live, tri, -1))
            u = rng.uniforms(seed, s, bounces - b, ray).to(dtype)
            state = shade(world, state, t, tri, u)
        acc = acc + torch.sqrt(torch.clamp(state[2], min=0.0))
        if record:
            topology.append(torch.stack(cols, dim=1))
    return acc / spp, topology, counts


def frame_rays(resolution, spp: int, bounces: int) -> int:
    """The work of a frame as the benchmark counts it: pixels x samples x
    bounces, dead lanes included."""
    return math.prod(resolution) * spp * bounces
