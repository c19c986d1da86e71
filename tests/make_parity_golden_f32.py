"""Render the f32 parity golden, ``assets/golden/reference_scene_parity_f32.bmp``.

The committed ``reference_scene_parity.bmp`` was rendered on a TPU, whose
default-precision ``@`` rounds the parity engine's transform operands to
bfloat16 (``tests/parity_golden_witness.py``).  This script renders the
same image with the JAX package's parity engine on the CPU, in f32, at
that golden's settings (``scripts/make_golden_parity.py``: 1000x800,
2 spp, 5 bounces, ``RenderConfig``'s seed, RNG tiles of 2048 rays), in
bands of whole RNG tiles with ``tile_base`` keeping the global tile
numbering, and writes it to a new file; no committed golden is touched:

    JAX_PLATFORMS=cpu python tests/make_parity_golden_f32.py [spp] [tiles_per_band]

It prints its wall time, the image's channel means and, both downsampled
by 8, its mean |diff| and correlation against the two committed goldens.
"""

import functools
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "assets", "golden", "reference_scene_parity_f32.bmp")
TILE = 2048


def main(argv) -> None:
    spp = int(argv[0]) if argv else 2
    tiles_per_band = int(argv[1]) if len(argv) > 1 else 16
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    from parity_golden_witness import GOLDENS, _down
    from pathtracerap_tpu.config import RenderConfig
    from pathtracerap_tpu.io.bmp import quantize_image, read_bmp, write_bmp
    from pathtracerap_tpu.render.camera import generate_rays
    from pathtracerap_tpu.render.wavefront import _make_tracer, _render_tile, render_ray_array
    from pathtracerap_tpu.scene.build import build_reference_scene

    cfg = RenderConfig(resolution=(1000, 800), samples_per_pixel=spp, max_bounces=5,
                       engine="parity")
    scene = build_reference_scene().to_device()
    key = jax.random.PRNGKey(cfg.seed)
    w, h = cfg.resolution
    ro, rd = generate_rays(cfg.camera, cfg.resolution)
    render_tile = functools.partial(
        _render_tile, _make_tracer(scene, "parity"), key=key, n_samples=spp,
        max_bounces=cfg.max_bounces, parity=True, sample_offset=0, scene=scene,
    )

    @jax.jit
    def render_band(ro_b, rd_b, base):
        return render_ray_array(render_tile, ro_b, rd_b, TILE, tile_base=base)

    band = tiles_per_band * TILE
    t_start = time.perf_counter()
    parts = []
    for s in range(0, w * h, band):
        t0 = time.perf_counter()
        parts.append(np.asarray(render_band(ro[s:s + band], rd[s:s + band], s // TILE)))
        print(f"rays {s}-{min(s + band, w * h)}: {time.perf_counter() - t0:.1f} s", flush=True)
    acc = np.concatenate(parts, axis=0)
    write_bmp(OUT, quantize_image(acc.reshape(h, w, 3), spp))
    wall = time.perf_counter() - t_start
    img = read_bmp(OUT).astype(np.float32) / 255.0
    print(f"wrote {OUT}: {wall:.1f} s, channel means {img.mean(axis=(0, 1)).tolist()}")
    for name in GOLDENS:
        g = read_bmp(os.path.join(ROOT, "assets", "golden", name)).astype(np.float32) / 255.0
        a, b = _down(img, 8), _down(g, 8)
        print(f"  against {name}: mean |diff| {float(np.abs(a - b).mean())}, "
              f"correlation {float(np.corrcoef(a.ravel(), b.ravel())[0, 1])}")


if __name__ == "__main__":
    main(sys.argv[1:])
