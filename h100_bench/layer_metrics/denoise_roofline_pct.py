"""Denoise: the six K2 passes' share of their bandwidth roofline.

The bytes are this file's own count, from the frame's size and the
G-buffer formats the configurations state, not from the port's layout.
Each pass reads each input once and writes its output once: the light
(3 x f32), depth (u16) and normal id (u8) in, the light (3 x f32) out;
the sixth pass writes the frame (3 x f32) in place of the light and
reads albedo, emission and fog (3 x f32 each) besides, and the blue-noise
texture (512 x 512 x 4 f32) once.  The pass reads a 3 x 3 neighbourhood
but every tap is counted once, as the roofline asks.  The operations
(a few dozen a tap) bound it below the bytes, so the bytes alone set the
least time: bytes / 3.35 TB/s (the H100 SXM's HBM3, at its 700 W limit;
the run states the card's power limit).  The share is that least time
over the measured time of the passes (``denoise_pass_kernel``).
"""

PEAK_BYTES_PER_S = 3.35e12
PASS_BYTES_PER_PX = 12 + 2 + 1 + 12
PASSES = 6
FINAL_EXTRA_BYTES_PER_PX = 3 * 12  # albedo, emission, fog
NOISE_BYTES = 512 * 512 * 4 * 4


def frame_bytes(width: int, height: int) -> int:
    px = width * height
    return PASSES * PASS_BYTES_PER_PX * px + FINAL_EXTRA_BYTES_PER_PX * px + NOISE_BYTES


def read(trace):
    ms = trace.ms_per_frame(r"\bdenoise_pass_kernel\b")
    if ms is None:
        return None
    cell = trace.cell
    least_s = frame_bytes(cell["width"], cell["height"]) / PEAK_BYTES_PER_S
    return 100.0 * least_s / (ms / 1e3)
