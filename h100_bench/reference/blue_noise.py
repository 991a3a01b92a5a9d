"""[Frozen copy of ``raytrace_tpu_torch/utils/blue_noise.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

Blue-noise texture generation.

A frozen copy of the generator of ``raytrace_tpu_torch/utils/blue_noise.py``
(the same generator and seed, so the same bytes), without its cache: the
reference makes the texture itself.

The reference ships a 512x512 RGBA blue-noise PNG asset
(src/render/pipeline/blue_noise_512.png, loaded at render_data.rs:110-133)
that seeds per-frame RNG and output dithering.  We synthesize an equivalent
texture instead of shipping a binary asset: white noise is spectrally shaped
with a radial high-pass in Fourier space and rank-order normalized back to a
uniform [0,255] distribution per channel.
"""

from __future__ import annotations

import numpy as np

from .constants import BLUE_NOISE_CHANNELS, BLUE_NOISE_HEIGHT, BLUE_NOISE_WIDTH


def _blue_channel(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """One uint8 blue-noise channel via FFT spectral shaping."""
    white = rng.standard_normal((h, w))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    radius = np.sqrt(fx * fx + fy * fy)
    # High-pass ramp: suppress low frequencies, keep energy at high ones.
    shaped = np.fft.ifft2(np.fft.fft2(white) * radius).real
    # Rank-order normalize to a uniform distribution over [0, 255].
    order = np.argsort(shaped, axis=None)
    out = np.empty(h * w, dtype=np.uint8)
    out[order] = (np.arange(h * w) * 256 // (h * w)).astype(np.uint8)
    return out.reshape(h, w)


def generate_blue_noise(
    height: int = BLUE_NOISE_HEIGHT,
    width: int = BLUE_NOISE_WIDTH,
    channels: int = BLUE_NOISE_CHANNELS,
    seed: int = 0x1D872B41,
) -> np.ndarray:
    """(H, W, C) uint8 blue-noise texture."""
    rng = np.random.default_rng(seed)
    return np.stack(
        [_blue_channel(rng, height, width) for _ in range(channels)], axis=-1
    )


def get_blue_noise_f32() -> np.ndarray:
    """Canonical float32 [0,1] conversion of the texture, divided in numpy
    as the port divides it (the tracer's noise-offset quantization is
    sensitive to the last ulp of k/255)."""
    return generate_blue_noise().astype(np.float32) / 255.0
