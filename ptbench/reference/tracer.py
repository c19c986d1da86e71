"""Brute-force nearest hit over every triangle, and the pair count that
the roofline metrics charge.

The accept chain is the renderer's epsilon-guarded Moeller-Trumbore test
in Pluecker form.  With the ray ``W = [d, o x d]`` (``d`` unit) and the
edge columns ``[p x q; q - p]`` of edges ab, bc, ca, the side values are
``s = W . column``; ``det = s_ab + s_bc + s_ca``, ``u = s_ca / det``,
``v = s_ab / det``, ``t = (n . a - o . n) / det`` with ``n = (b - a) x
(c - a)``.  A triangle is accepted when ``u, v, t >= -EPS``, ``u <= 1 +
EPS`` and ``u + v <= 1 + EPS``; the hit is the accepted triangle of least
``t``, ties to the lowest index.  No culling: every ray meets every
triangle.
"""

from __future__ import annotations

import dataclasses

import torch

from .world import World, cross, dot

EPS = 0.005  # Config.h:4
F_MAX = 9999999.0  # the miss distance (Config.h:5)
CHUNK_ELEMS = 1 << 25  # (ray, triangle) pairs per chunk of the sweep


@dataclasses.dataclass
class Operands:
    """Per-triangle columns of the accept chain, each (6 or 3, T)."""

    ab: torch.Tensor
    bc: torch.Tensor
    ca: torch.Tensor
    neg_n: torch.Tensor  # (3, T)
    d_plane: torch.Tensor  # (T,)
    box_lo: torch.Tensor  # (3, T) padded triangle boxes, for the pair count
    box_hi: torch.Tensor


def operands(world: World) -> Operands:
    a, b, c = world.a, world.b, world.c

    def edge(p, q):
        return torch.cat([cross(p, q), q - p], dim=1).T.contiguous()

    n = cross(b - a, c - a)
    lo = torch.minimum(torch.minimum(a, b), c)
    hi = torch.maximum(torch.maximum(a, b), c)
    pad = EPS * torch.sqrt(dot(hi - lo, hi - lo))[:, None]
    return Operands(ab=edge(a, b), bc=edge(b, c), ca=edge(c, a), neg_n=(-n).T.contiguous(),
                    d_plane=dot(n, a), box_lo=(lo - pad).T.contiguous(),
                    box_hi=(hi + pad).T.contiguous())


def _side(w, q):
    """(R, T) sums ``w . q`` over six rows, in order, by fused multiply-adds."""
    s = w[:, 0:1] * q[0]
    for k in range(1, 6):
        s.addcmul_(w[:, k:k + 1], q[k])
    return s


def nearest_hit(ops: Operands, o: torch.Tensor, d: torch.Tensor):
    """Nearest accepted triangle of each ray (``d`` unit).  Returns (t (N,),
    index (N,) int64, -1 on a miss, where t is ``F_MAX``)."""
    n_tri = ops.d_plane.shape[0]
    rows = max(1, CHUNK_ELEMS // max(n_tri, 1))
    ts, idxs = [], []
    for r0 in range(0, o.shape[0], rows):
        oc, dc = o[r0:r0 + rows], d[r0:r0 + rows]
        w = torch.cat([dc, cross(oc, dc)], dim=1)
        s_ab, s_bc, s_ca = _side(w, ops.ab), _side(w, ops.bc), _side(w, ops.ca)
        num = oc[:, 0:1] * ops.neg_n[0]
        num.addcmul_(oc[:, 1:2], ops.neg_n[1]).addcmul_(oc[:, 2:3], ops.neg_n[2])
        num += ops.d_plane
        inv = s_ab + s_bc
        del s_bc
        inv = torch.reciprocal(inv.add_(s_ca))
        t, u, v = num.mul_(inv), s_ca.mul_(inv), s_ab.mul_(inv)
        del inv
        ok = (u >= -EPS) & (v >= -EPS) & (t >= -EPS) & (u <= 1.0 + EPS) & ((u + v) <= 1.0 + EPS)
        best, idx = t.masked_fill_(~ok, F_MAX).min(dim=1)
        hit = best < F_MAX
        ts.append(torch.where(hit, best, F_MAX))
        idxs.append(torch.where(hit, idx, -1))
    if not ts:
        return o.new_zeros(0), torch.zeros(0, dtype=torch.int64, device=o.device)
    return torch.cat(ts), torch.cat(idxs)


def count_pairs(ops: Operands, o: torch.Tensor, d: torch.Tensor, t_end: torch.Tensor):
    """(N,) int64: for each ray the triangles whose box (padded by EPS of
    its diagonal) meets the segment ``o + s d``, ``0 <= s <= t_end``: the
    pairs an exact tracer has to test to find the nearest hit at
    ``t_end`` (``F_MAX`` for a miss)."""
    n_tri = ops.d_plane.shape[0]
    rows = max(1, CHUNK_ELEMS // max(n_tri, 1))
    out = []
    for r0 in range(0, o.shape[0], rows):
        oc, dc, te = o[r0:r0 + rows], d[r0:r0 + rows], t_end[r0:r0 + rows]
        enter = torch.zeros((oc.shape[0], n_tri), dtype=o.dtype, device=o.device)
        leave = te[:, None].expand(-1, n_tri).clone()
        for k in range(3):
            ok, dk = oc[:, k:k + 1], dc[:, k:k + 1]
            lo, hi = ops.box_lo[k], ops.box_hi[k]
            flat = dk == 0.0
            inv = 1.0 / torch.where(flat, 1.0, dk)
            t1, t2 = (lo - ok) * inv, (hi - ok) * inv
            inside = (lo <= ok) & (ok <= hi)
            near = torch.where(flat, torch.where(inside, -F_MAX, F_MAX), torch.minimum(t1, t2))
            far = torch.where(flat, torch.where(inside, F_MAX, -F_MAX), torch.maximum(t1, t2))
            enter = torch.maximum(enter, near)
            leave = torch.minimum(leave, far)
        out.append((enter <= leave).sum(dim=1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64, device=o.device)
