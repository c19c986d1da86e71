"""Where the parity golden's brightness offset comes from, on the CPU.

``assets/golden/reference_scene_parity.bmp`` (the JAX parity engine on a
TPU) is brighter than ``reference_scene.bmp`` (the fused engine), and
``tests/test_reference_golden.py`` pins that offset.  This script renders
the reference scene with the parity engine at a reduced resolution (2 spp,
5 bounces, as the golden) and prints the image's channel means and, both
downsampled to the same grid, its mean |diff| and correlation against
each golden:

    JAX_PLATFORMS=cpu python tests/parity_golden_witness.py jax_f32 [W H]
    JAX_PLATFORMS=cpu python tests/parity_golden_witness.py jax_bf16 [W H]
    JAX_PLATFORMS=cpu python tests/parity_golden_witness.py port [W H]

``jax_f32`` is the JAX package as the CPU runs it (f32 products);
``jax_bf16`` rounds the operands of the parity engine's three transforms
(``transform_position``, ``transform_direction``, ``transform_normal``,
each a ``@`` at JAX's default precision) to bfloat16 and accumulates in
f32, which is what a TPU does with a default-precision f32 product
(``jax_bf16:position`` or ``jax_bf16:direction,normal`` round only those);
``port`` is the PyTorch port's plain version on the CPU.  W and H default
to 200 and 160 and must divide 1000 and 800 by the same factor.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = ("reference_scene.bmp", "reference_scene_parity.bmp")


def _down(x: np.ndarray, f: int) -> np.ndarray:
    h, w, _ = x.shape
    return x[: h - h % f, : w - w % f].reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))


def _render(mode: str, w: int, h: int) -> np.ndarray:
    kw = dict(resolution=(w, h), samples_per_pixel=2, max_bounces=5, engine="parity")
    if mode == "port":
        import torch

        from pathtracerap_tpu_torch import RenderConfig, Renderer, build_reference_scene

        torch.set_num_threads(4)
        scene = build_reference_scene().to_device("cpu")
        return Renderer(scene, RenderConfig(**kw), device="cpu").render().numpy()
    import jax.numpy as jnp

    import pathtracerap_tpu.ops.intersect as JI
    from pathtracerap_tpu.config import RenderConfig
    from pathtracerap_tpu.ops.math import inv3x3
    from pathtracerap_tpu.render.wavefront import Renderer
    from pathtracerap_tpu.scene.build import build_reference_scene

    def r(x):
        return x.astype(jnp.bfloat16).astype(jnp.float32)

    bf16 = {
        "position": lambda p, m: r(p) @ r(m[:3, :3]).T + m[:3, 3],
        "direction": lambda d, m: r(d) @ r(m[:3, :3]).T,
        "normal": lambda n, m: r(n) @ r(inv3x3(m[:3, :3]).T).T,
    }
    if mode.startswith("jax_bf16"):
        for name in mode.split(":")[1].split(",") if ":" in mode else bf16:
            setattr(JI, f"transform_{name}", bf16[name])
    elif mode != "jax_f32":
        raise SystemExit(f"unknown mode {mode!r}: jax_f32, jax_bf16[:TRANSFORMS] or port")
    return np.asarray(Renderer(build_reference_scene().to_device(), RenderConfig(**kw)).render())


def main(argv) -> None:
    mode = argv[0]
    w, h = (int(argv[1]), int(argv[2])) if len(argv) > 2 else (200, 160)
    f = 1000 // w
    if f * w != 1000 or f * h != 800:
        raise SystemExit(f"{w}x{h} does not divide 1000x800 by one factor")
    sys.path.insert(0, ROOT)
    from pathtracerap_tpu_torch import read_bmp

    t0 = time.perf_counter()
    img = np.clip(_render(mode, w, h), 0.0, 1.0)
    print(f"{mode} {w}x{h}, 2 spp, 5 bounces: {time.perf_counter() - t0:.1f} s, "
          f"channel means {img.mean(axis=(0, 1)).tolist()}")
    for name in GOLDENS:
        g = read_bmp(os.path.join(ROOT, "assets", "golden", name)).astype(np.float32) / 255.0
        a, b = _down(img, 8), _down(g, 8 * f)
        print(f"  against {name} (channel means {g.mean(axis=(0, 1)).tolist()}): mean |diff| "
              f"{float(np.abs(a - b).mean())}, correlation {float(np.corrcoef(a.ravel(), b.ravel())[0, 1])}")


if __name__ == "__main__":
    main(sys.argv[1:])
