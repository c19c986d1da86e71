"""Plain SGD steps of inverse rendering on the instances' material colours.

A step traces its paths (:func:`.pathtrace.render` with ``record``), then
recomputes the image from the material colours along each path under
autograd: in parity mode a path's throughput is the product of the colours
it met (times 0.01 on a miss), so the paths' topology does not depend on
the colours.  The loss is the mean squared error against the target, and
the update ``p - lr * grad``.
"""

from __future__ import annotations

import torch

from .pathtrace import COAT, DIFFUSE, EMISSIVE, METAL, MISS, REFLECTIVE, render
from .world import World


def replay(world: World, colors: torch.Tensor, topology, bounces: int) -> torch.Tensor:
    """(N, 3) image of the recorded paths with per-instance ``colors``."""
    acc = None
    for topo in topology:
        n = topo.shape[0]
        color = torch.ones((n, 3), dtype=colors.dtype, device=colors.device)
        remaining = torch.full((n,), bounces, dtype=torch.int64, device=colors.device)
        for b in range(bounces):
            tri = topo[:, b]
            hit = tri >= 0
            k = tri.clamp(min=0)
            mt = world.mat_type[k]
            mc = torch.where(hit[:, None], colors[world.model[k]], 0.0)
            alive = remaining > 0
            scatters = (mt == DIFFUSE) | (mt == METAL) | (mt == COAT) | (mt == REFLECTIVE)
            shaded = alive & hit
            color = torch.where((shaded & (scatters | (mt == EMISSIVE)))[:, None], color * mc,
                                color)
            missed = alive & ~hit
            color = torch.where(missed[:, None], color * MISS, color)
            kill = missed | (shaded & (mt == EMISSIVE))
            remaining = torch.where(kill, 0, torch.where(alive, remaining - 1, remaining))
        c = torch.sqrt(torch.clamp(color, min=0.0))
        acc = c if acc is None else acc + c
    return acc / len(topology)


def sgd_steps(world: World, camera: dict, resolution, spp: int, bounces: int, seeds,
              target: torch.Tensor, colors: torch.Tensor, lr: float):
    """SGD steps from ``colors``, one per seed.  Returns (losses, the
    colours before each step and after the last)."""
    losses, history = [], [colors.detach()]
    for seed in seeds:
        _, topology, _ = render(world, camera, resolution, spp, bounces, seed,
                                dtype=colors.dtype, record=True)
        p = history[-1].clone().requires_grad_(True)
        loss = ((replay(world, p, topology, bounces) - target) ** 2).mean()
        (grad,) = torch.autograd.grad(loss, [p])
        losses.append(float(loss.detach()))
        history.append((p - lr * grad).detach())
        del topology
    return losses, history
