"""Frame operations: rays, region tables, the path march (K1), shading,
denoise and finalize (K2)."""
