"""Frame operations: rays, heightfield and occupancy tables, the fused
volume format, the path marches (K1, K3) and their shades, shading,
denoise and finalize (K2)."""
