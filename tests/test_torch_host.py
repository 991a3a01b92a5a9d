"""The port's own host modules against the JAX package's.

The port keeps its own copies of ``constants``, ``materials`` (with its own
``data/materials.csv``) and ``utils/blue_noise``, so that it imports
nothing of ``raytrace_tpu``.  These hold the copies equal to the
originals.
"""

import numpy as np
import pytest

from raytrace_tpu import constants as jax_constants
from raytrace_tpu import materials as jax_materials
from raytrace_tpu.utils import blue_noise as jax_blue_noise
from raytrace_tpu_torch import constants, materials
from raytrace_tpu_torch.utils import blue_noise


def _public(module):
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and not callable(v) and not hasattr(v, "__spec__")}


def test_constants_equal():
    ours, theirs = _public(constants), _public(jax_constants)
    assert ours.keys() == theirs.keys()
    for name, value in theirs.items():
        assert ours[name] == value, name


def test_material_tables_equal():
    assert [m.pack() for m in materials.MATERIALS] == \
        [m.pack() for m in jax_materials.MATERIALS]
    assert [(m.albedo, m.emission, m.solid) for m in materials.MATERIALS] == \
        [(m.albedo, m.emission, m.solid) for m in jax_materials.MATERIALS]
    for name in ("PACKED_MATERIALS", "SOLID_TABLE", "ALBEDO_TABLE", "EMISSION_TABLE"):
        ours, theirs = getattr(materials, name), getattr(jax_materials, name)
        assert ours.dtype == theirs.dtype, name
        np.testing.assert_array_equal(ours, theirs, name)
    assert materials.NUM_MATERIALS == jax_materials.NUM_MATERIALS
    packed = np.arange(0, 1 << 22, 4099, dtype=np.uint32)
    np.testing.assert_array_equal(materials.unpack_albedo_np(packed),
                                  jax_materials.unpack_albedo_np(packed))


def test_material_csv_is_the_ports_own():
    assert materials._CSV_PATH.parent.parent.name == "raytrace_tpu_torch"
    assert materials._CSV_PATH.read_bytes() == jax_materials._CSV_PATH.read_bytes()


@pytest.mark.parametrize("shape", [(512, 512, 4), (64, 32, 2)])
def test_blue_noise_generator_byte_equal(shape):
    """The generator itself, not the cache: same seed, same bytes."""
    h, w, c = shape
    ours = blue_noise.generate_blue_noise(h, w, c)
    theirs = jax_blue_noise.generate_blue_noise(h, w, c)
    assert ours.dtype == theirs.dtype == np.uint8 and ours.shape == shape
    assert ours.tobytes() == theirs.tobytes()


def test_blue_noise_shares_the_cache_and_its_conversion():
    assert blue_noise._CACHE == jax_blue_noise._CACHE
    np.testing.assert_array_equal(blue_noise.get_blue_noise_f32(),
                                  jax_blue_noise.get_blue_noise_f32())
