"""Camera, shading and the wavefront render facade."""
