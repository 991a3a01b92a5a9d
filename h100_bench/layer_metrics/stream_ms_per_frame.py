"""Streaming and world tables: device ms a frame of the region's
heightfield tables T1 (``hf_tables_kernel``), the streamed slabs and
regions G1 (``worldgen_kernel``, ``worldgen_box_kernel``) and the
occupancy tables O1 (``vol_tables_kernel``)."""

PATTERN = r"\b(hf_tables_kernel|worldgen_kernel|worldgen_box_kernel|vol_tables_kernel)\b"


def read(trace):
    return trace.ms_per_frame(PATTERN)
