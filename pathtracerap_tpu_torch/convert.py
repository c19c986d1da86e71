"""The JAX package's device data as the port's dataclasses.

The JAX package's ``SceneDevice`` and ``WorldTriangles`` arrive here as a
dict of their fields, each one ``np.asarray``'d (the static ints as they
are).  Fields the port has no use for (the uniform grids, the dense
kernel's packs) are dropped.  With these, the JAX bake can be fed to the
port's renderer so the two renderers are compared alone.
:func:`params_from_numpy` does the same for a JAX ``extract_params`` dict.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .scene.types import SceneDevice, WorldTriangles

_INT_FIELDS = ("tri_block", "n_valid", "n_world_valid")


def _from_numpy(cls, fields: dict, device):
    out = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields or fields[f.name] is None:
            continue
        v = fields[f.name]
        if f.name in _INT_FIELDS:
            out[f.name] = int(v)
        else:
            out[f.name] = torch.as_tensor(np.array(v), device=device)
    return cls(**out)


def scene_from_numpy(fields: dict, device) -> SceneDevice:
    """A :class:`SceneDevice` on ``device`` from the JAX one's fields."""
    return _from_numpy(SceneDevice, fields, device)


def world_from_numpy(fields: dict, device) -> WorldTriangles:
    """A :class:`WorldTriangles` on ``device`` from the JAX one's fields."""
    return _from_numpy(WorldTriangles, fields, device)


def params_from_numpy(fields: dict, device) -> dict:
    """The port's parameter leaves (``requires_grad=True``) on ``device``
    from a JAX ``extract_params`` dict."""
    return {
        k: torch.tensor(np.array(v), dtype=torch.float32, device=device, requires_grad=True)
        for k, v in fields.items()
    }
