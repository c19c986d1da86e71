from .reference import trace_scalar, shade_scalar, render_scalar

__all__ = ["trace_scalar", "shade_scalar", "render_scalar"]
