"""Frame operations: rays, heightfield and occupancy tables, the fused
volume format, the path marches (K1, K3) and their shades, the staged
tracers (K4, the exact DDA) and their lighting pass, shading, denoise and
finalize (K2)."""
