"""Vector math, sampling, RNG, hit records and the world bake."""
