"""World-space triangles of a scene, worked out from the scene inputs.

Each instance's mesh is moved by its model-to-world matrix; each triangle
keeps its corners ``a, b, c``, its shading normal (the inverse transpose
of the matrix's 3x3 applied to the mean of the corners' normals, then
normalized, as ``Renderer.cpp:203,397`` shades) and its instance's
material.  Triangles are in instance order, then mesh order.

Sums of products are written as ``addcmul`` chains (fused multiply-adds)
so that the float32 arithmetic rounds as a fused kernel does; in another
dtype the same code runs in that dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def dot(a, b):
    return torch.addcmul(torch.addcmul(a[..., 0] * b[..., 0], a[..., 1], b[..., 1]),
                         a[..., 2], b[..., 2])


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([torch.addcmul(-(az * by), ay, bz),
                        torch.addcmul(-(ax * bz), az, bx),
                        torch.addcmul(-(ay * bx), ax, by)], dim=-1)


def normalize(v):
    return v / torch.sqrt(dot(v, v))[..., None]


@dataclasses.dataclass
class World:
    a: torch.Tensor  # (T, 3) corners
    b: torch.Tensor
    c: torch.Tensor
    shade_n: torch.Tensor  # (T, 3)
    model: torch.Tensor  # (T,) int64 instance
    mat_type: torch.Tensor  # (T,) int64
    mat_color: torch.Tensor  # (I, 3) per instance


def _inv3(m):
    """Cofactor inverse of (I, 3, 3)."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    g, h, i = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    ca, cb, cc = e * i - f * h, -(d * i - f * g), d * h - e * g
    cd, ce, cf = -(b * i - c * h), a * i - c * g, -(a * h - b * g)
    cg, ch, ci = b * f - c * e, -(a * f - c * d), a * e - b * d
    det = a * ca + b * cb + c * cc
    inv = torch.stack([torch.stack([ca, cd, cg], -1), torch.stack([cb, ce, ch], -1),
                       torch.stack([cc, cf, ci], -1)], -2)
    return inv / det[:, None, None]


def _apply(m, p):
    """(T, 3, 3) @ (T, 3), the products summed by fused multiply-adds."""
    return torch.addcmul(torch.addcmul(m[:, :, 0] * p[:, None, 0], m[:, :, 1], p[:, None, 1]),
                         m[:, :, 2], p[:, None, 2])


def build_world(inputs, device, dtype=torch.float32) -> World:
    """The world-space triangles of ``inputs`` (a ``ptbench.scenes.SceneInputs``)."""
    pos, nrm, tri, model = [], [], [], []
    off = 0
    for i, m in enumerate(inputs.instance_mesh):
        mesh = inputs.meshes[int(m)]
        pos.append(mesh.positions)
        nrm.append(mesh.normals)
        tri.append(mesh.triangles + off)
        model.append(np.full(mesh.triangles.shape[0], i, np.int64))
        off += mesh.positions.shape[0]

    def put(x, dt=dtype):
        return torch.as_tensor(np.concatenate(x) if isinstance(x, list) else x).to(device, dt)

    p, n, t = put(pos), put(nrm), put(tri, torch.int64)
    mdl = put(model, torch.int64)
    m2w = put(inputs.model_to_world)[mdl]  # (T, 4, 4)
    rot, trans = m2w[:, :3, :3], m2w[:, :3, 3]
    a, b, c = (_apply(rot, p[t[:, k]]) + trans for k in range(3))
    inv_t = _inv3(put(inputs.model_to_world)[:, :3, :3]).transpose(1, 2)[mdl]
    navg = (n[t[:, 0]] + n[t[:, 1]] + n[t[:, 2]]) * (1.0 / 3.0)
    shade_n = _apply(inv_t, navg)
    ok = dot(shade_n, shade_n)[:, None] > 1e-30
    shade_n = normalize(torch.where(ok, shade_n, torch.tensor([1.0, 0.0, 0.0], dtype=dtype,
                                                               device=device)))
    return World(a=a, b=b, c=c, shade_n=shade_n, model=mdl,
                 mat_type=put(inputs.mat_type, torch.int64)[mdl],
                 mat_color=put(inputs.mat_color))
