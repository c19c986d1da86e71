"""The glass scene in quality mode (``scenes/glass_sphere.scn``: a
REFRACTIVE sphere and a SPECULAR slab) on the port, against the JAX
package's renders at the same settings.

Mirrors tests/test_refraction.py:110, :120, :139 and :150, the committed
``assets/golden/glass_sphere.bmp`` included.  Quality mode turns discrete
decisions on computed floats into whole paths: the Fresnel roulette, and
the nearest of two sphere triangles whose t nearly ties at a shared edge
(an ulp apart between two layouts of the arithmetic, ROADMAP queue C), whose
normals then refract the ray differently.  One such path moves the mean
of a 48x36 render by about 1e-4.  So, as JAX holds its own engines at
48x36, 4 spp, 4 bounces: under 0.5 % of the components may differ by more
than 1e-5, and the means agree within 1e-3.  Where no such decision
changes a contribution (parity mode, which passes glass and mirror
through unshaded, and these 2-bounce renders) every component agrees
within 1e-5.  At the golden's 96x72, 8 spp, 6 bounces JAX's own engines
differ on about 1 % of the components, so the port is held to JAX's
render there by the golden's bounds.
"""

import os

import numpy as np
import pytest

from pathtracerap_tpu.render.wavefront import Renderer as JRenderer
from pathtracerap_tpu.render.wavefront import effective_engine as jax_effective_engine
from pathtracerap_tpu.scene.dsl import load_scene_file as jax_load_scene_file
from pathtracerap_tpu.scene.dsl import render_config_from_parsed as jax_config
from pathtracerap_tpu_torch import Renderer, read_bmp
from pathtracerap_tpu_torch.scene.dsl import load_scene_file, render_config_from_parsed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLASS = os.path.join(ROOT, "scenes", "glass_sphere.scn")
GOLDEN = os.path.join(ROOT, "assets", "golden", "glass_sphere.bmp")
ROULETTE_SHARE = 0.005  # components allowed to differ by more than 1e-5
MEAN_ATOL = 1e-3  # the means of two renders whose roulettes may flip
SMALL = dict(spp=4, res=(48, 36), bounces=4)
GOLDEN_SETTINGS = dict(spp=8, res=(96, 72), bounces=6)


@pytest.fixture(scope="module")
def glass():
    p = load_scene_file(GLASS)
    return p, p.scene.to_device("cpu")


@pytest.fixture(scope="module")
def jax_glass():
    p = jax_load_scene_file(GLASS)
    return p, p.scene.to_device()


@pytest.fixture(scope="module")
def jax_renders(jax_glass):
    """JAX's renders, each made once for the module, keyed on the engine
    the render resolves to (``fused`` routes this multi-block scene to
    ``binned``)."""
    cache = {}

    def render(engine, parity, spp, res, bounces):
        p, dev = jax_glass
        cfg = jax_config(p, engine=engine, parity=parity, samples_per_pixel=spp,
                         resolution=res, max_bounces=bounces)
        r = JRenderer(dev, cfg)
        k = (jax_effective_engine(engine, r.world, cfg.camera.jitter), parity, spp, res, bounces)
        if k not in cache:
            cache[k] = np.asarray(r.render())
        return cache[k]

    return render


@pytest.fixture(scope="module")
def port_renders(glass):
    """The port's renders, each made once for the module, keyed on the
    engine the render resolves to."""
    cache = {}

    def render(engine, parity, spp, res, bounces):
        p, dev = glass
        cfg = render_config_from_parsed(p, engine=engine, parity=parity, samples_per_pixel=spp,
                                        resolution=res, max_bounces=bounces)
        r = Renderer(dev, cfg, device="cpu")
        k = (r.engine, parity, spp, res, bounces)
        if k not in cache:
            cache[k] = r.render().numpy()
        return cache[k]

    return render


def _agree(img, ref):
    share = float((np.abs(img - ref) > 1e-5).mean())
    assert share < ROULETTE_SHARE, f"{share:.4%} of components differ"
    assert abs(float(img.mean() - ref.mean())) < MEAN_ATOL


def _downsampled(x):
    return x.reshape(18, 4, 24, 4, 3).mean(axis=(1, 3))


def _golden_bounds(img, ref):
    """tests/test_refraction.py:150's bounds after downsampling by 4."""
    mad = float(np.abs(_downsampled(img) - _downsampled(ref)).mean())
    corr = float(np.corrcoef(_downsampled(img).ravel(), _downsampled(ref).ravel())[0, 1])
    assert mad < 0.04, mad
    assert corr > 0.97, corr


def _small(render, engine, parity, bounces=SMALL["bounces"]):
    return render(engine, parity, SMALL["spp"], SMALL["res"], bounces)


def test_quality_mode_refraction_matches_jax(port_renders, jax_renders):
    """tests/test_refraction.py:110's quality render (mxu) against JAX's."""
    img = _small(port_renders, "mxu", False)
    assert np.isfinite(img).all() and img.max() > 0.05
    _agree(img, _small(jax_renders, "mxu", False))


@pytest.mark.parametrize("parity,bounces", [(True, 4), (False, 2)], ids=["parity", "quality_2"])
def test_renders_without_a_flip_equal_jax(port_renders, jax_renders, parity, bounces):
    """Renders where no discrete decision changes a contribution: every
    component within 1e-5."""
    img = _small(port_renders, "mxu", parity, bounces)
    np.testing.assert_allclose(img, _small(jax_renders, "mxu", parity, bounces), rtol=0,
                               atol=1e-5)


def test_quality_mode_refraction_changes_the_image(port_renders):
    """tests/test_refraction.py:110: the two modes differ where glass and
    mirror are seen."""
    assert np.abs(_small(port_renders, "mxu", False) - _small(port_renders, "mxu", True)).max() > 0.05


@pytest.mark.parametrize("engine", ["fused", "binned"])
def test_quality_refraction_engines_agree(port_renders, jax_renders, engine):
    """tests/test_refraction.py:120: the megakernel engines against the
    port's mxu render, and against JAX's render on the same engine."""
    img = _small(port_renders, engine, False)
    _agree(img, _small(port_renders, "mxu", False))
    _agree(img, _small(jax_renders, engine, False))


def test_dsl_quality_flag_and_ri_plumbing(glass, jax_glass):
    """tests/test_refraction.py:139."""
    p, dev = glass
    cfg = render_config_from_parsed(p)
    assert cfg.parity is False and cfg.max_bounces == 6
    assert cfg.to_dict() == jax_config(jax_glass[0]).to_dict()
    assert np.isclose(dev.mat_refractive_index.max().item(), 1.5)
    np.testing.assert_array_equal(dev.mat_refractive_index.numpy(),
                                  np.asarray(jax_glass[1].mat_refractive_index))


def test_committed_glass_golden(port_renders, jax_renders):
    """tests/test_refraction.py:150: ``fused`` at 96x72, 8 spp, 6 bounces
    against the committed golden (mean |diff| < 0.04, correlation > 0.97
    after downsampling by 4), and against JAX's render by the same bounds
    and the means within 1e-3."""
    s = GOLDEN_SETTINGS
    img = port_renders("fused", False, s["spp"], s["res"], s["bounces"])
    gold = read_bmp(GOLDEN).astype(np.float32) / 255.0
    assert gold.shape == img.shape == (72, 96, 3)
    _golden_bounds(img, gold)
    ref = jax_renders("fused", False, s["spp"], s["res"], s["bounces"])
    _golden_bounds(img, ref)
    assert abs(float(img.mean() - ref.mean())) < MEAN_ATOL
