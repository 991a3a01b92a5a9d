"""The benchmark's plain reference: what the port's frame should be.

A frozen copy of the port's plain PyTorch world generation, region and
occupancy tables, frame rays, marches (K1's and K3's plain versions),
shades, denoise chain and finalize, with the kernel wrappers removed
(each copied module says which file it was copied from).  ``frame`` holds
the drivers the check calls.  It imports nothing of ``raytrace_tpu_torch``,
``raytrace_tpu`` or ``jax``, and takes nothing the program made: it works
each world and frame out again from the seed and the frame's uniforms.
"""
