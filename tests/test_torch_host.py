"""The port's copies of the JAX package's host modules (``constants``,
``config``, ``io.bmp``, ``io.obj``) against the originals."""

import dataclasses
import os

import numpy as np
import pytest

from pathtracerap_tpu import config as jconfig
from pathtracerap_tpu import constants as jconstants
from pathtracerap_tpu.io import bmp as jbmp
from pathtracerap_tpu.io import obj as jobj
from pathtracerap_tpu_torch import config, constants
from pathtracerap_tpu_torch.io import bmp, obj

MESHES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets", "meshes")


def test_constants_equal():
    names = [n for n in vars(constants) if n.isupper()]
    assert len(names) >= 15
    for name in names:
        assert getattr(constants, name) == getattr(jconstants, name), name


@pytest.mark.parametrize("cls", ["CameraConfig", "RenderConfig"])
def test_config_fields_and_defaults_equal(cls):
    port, ref = getattr(config, cls), getattr(jconfig, cls)
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port()) == dataclasses.asdict(ref())


def test_render_config_round_trips_as_jax_does():
    cfg = config.RenderConfig(resolution=(64, 32), samples_per_pixel=3, engine="fused",
                              parity=False, camera=config.CameraConfig(jitter=True))
    jcfg = jconfig.RenderConfig(resolution=(64, 32), samples_per_pixel=3, engine="fused",
                                parity=False, camera=jconfig.CameraConfig(jitter=True))
    assert cfg.to_dict() == jcfg.to_dict() and cfg.to_json() == jcfg.to_json()
    assert config.RenderConfig.from_dict(cfg.to_dict()) == cfg
    assert config.RenderConfig.from_json(jcfg.to_json()) == cfg
    assert cfg.n_pixels == jcfg.n_pixels == 2048


@pytest.mark.parametrize("parity", [True, False])
def test_bmp_bytes_equal(tmp_path, parity):
    image = np.random.default_rng(3).integers(0, 256, size=(5, 7, 3), dtype=np.uint8)
    a, b = tmp_path / "port.bmp", tmp_path / "jax.bmp"
    bmp.write_bmp(str(a), image, parity=parity)
    jbmp.write_bmp(str(b), image, parity=parity, backend="python")
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(bmp.read_bmp(str(a), parity=parity), image)
    accum = np.random.default_rng(4).uniform(0, 9, size=(5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(bmp.quantize_image(accum, 8), jbmp.quantize_image(accum, 8))


@pytest.mark.parametrize("name", ["blender_monkey.obj", "ceiling_light.obj"])
def test_load_obj_arrays_equal(name):
    path = os.path.join(MESHES, name)
    port, ref = obj.load_obj(path), jobj.load_obj(path, backend="python")
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(port, f.name), getattr(ref, f.name), err_msg=f.name)
    assert port.num_triangles == ref.num_triangles > 0
