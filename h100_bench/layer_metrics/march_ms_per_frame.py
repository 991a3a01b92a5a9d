"""March: device ms a frame of the port's path and ray marches (K1
``march_paths_kernel``, K3 ``march_paths_vol_kernel``; the staged tracers'
K3s, K4 and the exact DDA D1 where a configuration runs them)."""

PATTERN = (r"\b(march_paths_kernel|march_paths_vol_kernel|trace_rays_vol_kernel"
           r"|trace_hf_kernel|trace_dda_kernel)\b")


def read(trace):
    return trace.ms_per_frame(PATTERN)
