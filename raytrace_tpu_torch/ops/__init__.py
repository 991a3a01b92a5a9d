"""Frame operations: rays, heightfield and occupancy tables, the fused
volume format, the path marches (K1, K3) and their shades, the staged
tracers (K4, the exact DDA) and their lighting pass, shading, denoise and
finalize (K2, F1).

The names JAX's ``raytrace_tpu/ops/__init__.py`` exports have their
counterparts here."""
from .shading import sun_color, sample_sky, sun_direction, filmic_curve  # noqa: F401
from .trace_dda import trace_rays, render_gbuffers  # noqa: F401
from .denoise import bilateral_denoise, denoise_chain  # noqa: F401
from .finalize import finalize_frame  # noqa: F401
