"""Rays and shade: device ms a frame of the frame's rays R1
(``frame_rays_kernel``) and the shades S1 (``sky_table_kernel``,
``shade_fused_kernel``) and S3 (``shade_vol_kernel``); the staged glue P1
and S2 and the lone finalize F1 where a configuration runs them."""

PATTERN = (r"\b(frame_rays_kernel|sky_table_kernel|shade_fused_kernel|shade_vol_kernel"
           r"|leg_batch_kernel|shade_staged_kernel|finalize_kernel)\b")


def read(trace):
    return trace.ms_per_frame(PATTERN)
