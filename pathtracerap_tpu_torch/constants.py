"""Numeric constants of the renderer (the port's copy of
``pathtracerap_tpu/constants.py``, trimmed to the names the port uses).

They mirror the reference renderer's compile-time configuration
(``Config.h:4-19`` and the math macros of ``utility.h:12-22``);
``tests/test_torch_host.py`` holds every value here equal to the JAX
package's.
"""

# Epsilon used by the reference for all comparisons (Config.h:4).
EPSILON = 0.005

# The reference's miss sentinel for impact distances (Config.h:5,
# Renderer.cpp:384,402); not IEEE inf.
FLOAT_MAX = 9999999.0
FLOAT_MIN = -9999990.0

# Uniform-grid resolution per mesh (Config.h:8-10).
GRID_X = 25
GRID_Y = 25
GRID_Z = 25

# Default framebuffer (Config.h:12-15).
RESOLUTION_X = 1000
RESOLUTION_Y = 800

# Mesh positions are scaled by this factor at import time (Config.h:17,
# Scene.cpp:255-262).
BASE_MODEL_SCALE = 1000.0

# Samples per pixel == iteration count of the render loop (Config.h:19).
ITER = 500

# Max path depth: rays are created with 5 remaining bounces
# (Renderer.cpp:550).
MAX_BOUNCES = 5

# Spawn-point offset along the surface normal after every scatter
# (Renderer.cpp:437,444,451,465).
SPAWN_OFFSET = 0.1

# Throughput multiplier applied on a miss (Renderer.cpp:423,474).
MISS_ATTENUATION = 0.01

# Phong exponent of the METAL lobe (utility.h:158).
METAL_PHONG_EXPONENT = 30.0

# Russian-roulette threshold of the COAT material (utility.h:130).
COAT_REFLECT_PROBABILITY = 0.5

TWO_PI = 6.2831853071795864769252867665590057683943
SQRT_OF_ONE_THIRD = 0.5773502691896257645091487805019574556476
