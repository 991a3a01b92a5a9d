"""World math on tensors: noise, heights, material bands, voxel boxes,
the minefield and edits."""

from .heightmap import generate_heightmap, height_at  # noqa: F401
from .noise import (  # noqa: F401
    basic_multi,
    basic_multi_lowgrad,
    mountain_noise,
    mountain_noise2,
    mountain_noise2_grid,
    perlin2,
    perlin2_grad,
    worley2,
)
