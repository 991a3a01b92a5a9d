"""World math of the PyTorch port against the JAX package.

The integer hashes, material bands, lattice words, heights and region
tables must be bit-exact with the JAX functions run op by op (eagerly, or
under ``jax.disable_jit`` where the JAX function is jitted).  Under ``jit``
XLA's CPU compiler contracts multiply-adds and turns divisions by constants
into reciprocal multiplies, so a jitted JAX builder can differ from the op-
by-op one in the last quantum; those comparisons carry their own bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytrace_tpu.ops import trace_pallas as jax_tables
from raytrace_tpu.world import generate as jax_gen
from raytrace_tpu.world import heightmap as jax_hm
from raytrace_tpu.world import noise as jax_noise
from raytrace_tpu_torch.ops import hf_tables
from raytrace_tpu_torch.world import generate, heightmap, noise

OFFSETS = [(0, 0), (-96, -96), (-32, 64), (1024, -2048), (40960, -37888)]


def _ints(seed, n, lo, hi):
    return np.random.default_rng(seed).integers(lo, hi, n).astype(np.int32)


def test_mix_and_hashes_equal():
    h = _ints(0, 4096, -(2**31), 2**31 - 1)
    got = noise._mix(torch.from_numpy(h)).numpy()
    want = np.asarray(jax_noise._mix(jnp.asarray(h)))
    np.testing.assert_array_equal(got, want)
    x, y, z = _ints(1, 4096, -10**6, 10**6), _ints(2, 4096, -10**6, 10**6), \
        _ints(3, 4096, -64, 400)
    for seed in (0, 1, 7, 2**31 - 1):
        got = noise._hash2(torch.from_numpy(x), torch.from_numpy(y), seed)
        want = np.asarray(jax_noise._hash2(jnp.asarray(x), jnp.asarray(y), seed))
        np.testing.assert_array_equal(got.numpy(), want)
        got = noise.hash3_u32(*map(torch.from_numpy, (x, y, z)), seed)
        want = np.asarray(jax_noise.hash3_u32(*map(jnp.asarray, (x, y, z)), seed))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_material_band_equal():
    z = np.repeat(np.arange(-40, 240, dtype=np.int32), 64)
    bits = np.random.default_rng(4).integers(0, 2**32, z.size, dtype=np.uint64)
    bits[:6] = [0, 1, 59, 79, 0x7FFFFFFF, 0xFFFFFFFF]
    want = np.asarray(jax_gen.material_band(jnp.asarray(z),
                                            jnp.asarray(bits.astype(np.uint32))))
    got = generate.material_band(torch.from_numpy(z),
                                 torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("off", [(0, 0), (-128, -128), (1024, -2048), (40960, -37888)])
def test_lattice_fields_q_equal(off):
    k = np.arange(33, dtype=np.int32) * 8
    lx = np.broadcast_to(off[0] + k[None, :], (33, 33)).copy()
    ly = np.broadcast_to(off[1] + k[:, None], (33, 33)).copy()
    want = jax_hm.lattice_fields_q(jnp.asarray(lx), jnp.asarray(ly), 0)
    got = heightmap.lattice_fields_q(torch.from_numpy(lx), torch.from_numpy(ly), 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("lr", OFFSETS)
def test_heightmap_grid(lr):
    got = heightmap.heightmap_grid(lr[0], lr[1], (256, 256), seed=0, device="cpu").numpy()
    with jax.disable_jit():
        eager = np.asarray(jax_hm.heightmap_grid(lr[0], lr[1], (256, 256), seed=0))
    np.testing.assert_array_equal(got, eager)
    jitted = np.asarray(jax_hm.heightmap_grid(lr[0], lr[1], (256, 256), seed=0))
    diff = np.abs(got.astype(np.int64) - jitted)
    print(f"lr={lr}: {int((diff != 0).sum())} of {diff.size} columns differ "
          "from the jitted JAX heights")
    assert diff.max() <= 1
    assert (diff != 0).mean() <= 0.001


@pytest.fixture(scope="module")
def tables_lr0():
    lr = jnp.zeros(3, jnp.int32)
    with jax.disable_jit():
        eager = jax_tables.build_hf_tables(lr, seed=0)
    jitted = jax_tables.build_hf_tables(lr, seed=0)
    port = hf_tables.build_hf_tables((0, 0, 0), seed=0, device="cpu")
    np_ = lambda t: {k: np.asarray(v).reshape(-1) for k, v in t.items()}
    return np_(eager), np_(jitted), {k: v.numpy() for k, v in port.items()}


@pytest.mark.parametrize("key", ["h3", "hsub", "cA", "cB", "cC", "cD", "r0"])
def test_build_hf_tables_equal(tables_lr0, key):
    eager, jitted, port = tables_lr0
    np.testing.assert_array_equal(port[key], eager[key])
    if key in ("h3", "hsub", "r0"):
        np.testing.assert_array_equal(port[key], jitted[key])
    else:
        # Lattice words r16 | e16 << 16: the jitted builder may round a
        # field one quantum apart.
        for sh in (0, 16):
            d = np.abs(((port[key] >> sh) & 0xFFFF) - ((jitted[key] >> sh) & 0xFFFF))
            assert d.max() <= 1, key


COLUMN_REGIONS = [(0, 0, 0), (-300, 517, 0), (1000, -1000, 0)]


def _corner_words(tables):
    """Each column's block index and world coordinates in the region."""
    n = 256
    rx = torch.arange(n, dtype=torch.int32)[None, :].expand(n, n)
    ry = torch.arange(n, dtype=torch.int32)[:, None].expand(n, n)
    i3 = ((ry >> 3) * 32 + (rx >> 3)).long()
    r0x, r0y = (int(v) for v in tables["r0"])
    return i3, rx + r0x, ry + r0y


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("lr", COLUMN_REGIONS)
def test_column_heights_equal_height_from_corners(lr, seed):
    """The column table K1 reads: the port's height_from_corners of every
    column (clamped at 0), and JAX's _height_from_corners run op by op,
    bit for bit."""
    tables = hf_tables.build_hf_tables(lr, seed=seed, device="cpu")
    got = hf_tables.column_heights(tables, seed)
    assert got.dtype == torch.int16 and got.shape == (256 * 256,)
    i3, xi, yi = _corner_words(tables)
    corners = [tables[k][i3] for k in ("cA", "cB", "cC", "cD")]
    port = torch.clamp(hf_tables.height_from_corners(*corners, xi, yi, seed), min=0)
    np.testing.assert_array_equal(got.reshape(256, 256).numpy(), port.numpy())
    with jax.disable_jit():
        want = jax_tables._height_from_corners(
            *(jnp.asarray(c.numpy()) for c in corners), jnp.asarray(xi.numpy()),
            jnp.asarray(yi.numpy()), seed)
    np.testing.assert_array_equal(got.reshape(256, 256).numpy(),
                                  np.maximum(np.asarray(want), 0))


def test_with_column_heights_keeps_the_tables():
    """The column table goes beside the six words and r0, which stay as
    build_hf_tables gives them."""
    tables = hf_tables.build_hf_tables((-300, 517, 0), seed=7, device="cpu")
    both = hf_tables.with_column_heights(tables, 7)
    assert set(both) == set(tables) | {"hcol"}
    assert all(both[k] is tables[k] for k in tables)
    assert set(tables) == set(hf_tables.TABLE_KEYS) | {"r0"}
    assert torch.equal(both["hcol"], hf_tables.column_heights(tables, 7))


# The rest of the public world API (``raytrace_tpu.world``): the noise
# functions within test_noise.py's tolerance (1e-6: PyTorch's CPU ``sqrt`` and
# ``pow`` can round the last bit otherwise than XLA's), heights exact.
NOISE_ATOL = 1e-6
NOISE_FUNCTIONS = ["worley2", "mountain_noise", "mountain_noise2", "perlin2_grad",
                   "basic_multi_lowgrad"]


def _coords(seed, scale):
    rng = np.random.default_rng(seed)
    x, y = (rng.uniform(-300, 300, (48, 48)).astype(np.float32) * np.float32(scale)
            for _ in range(2))
    return x, y


@pytest.mark.parametrize("scale", [1.0, 0.02])
@pytest.mark.parametrize("name", NOISE_FUNCTIONS)
def test_noise_api_matches_jax(name, scale):
    x, y = _coords(5, scale)
    got = getattr(noise, name)(torch.from_numpy(x), torch.from_numpy(y), 3)
    want = getattr(jax_noise, name)(jnp.asarray(x), jnp.asarray(y), 3)
    got, want = (v if isinstance(v, tuple) else (v,) for v in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=NOISE_ATOL)


@pytest.mark.parametrize("origin", [(0, 0), (-1000, 500), (40960, -37888)])
def test_mountain_noise2_grid_matches_jax(origin):
    got = noise.mountain_noise2_grid(origin[0], origin[1], (40, 48), seed=0, device="cpu").numpy()
    with jax.disable_jit():
        eager = np.asarray(jax_noise.mountain_noise2_grid(origin[0], origin[1], (40, 48), 0))
    jitted = np.asarray(jax_noise.mountain_noise2_grid(origin[0], origin[1], (40, 48), 0))
    assert got.shape == (40, 48)
    np.testing.assert_allclose(got, eager, rtol=0, atol=NOISE_ATOL)
    np.testing.assert_allclose(got, jitted, rtol=0, atol=NOISE_ATOL)


def test_height_at_equal():
    """Integer columns and floored float coordinates, near and far from
    the origin: the same heights as the JAX function."""
    xi, yi = _ints(6, 4096, -10**5, 10**5), _ints(7, 4096, -10**5, 10**5)
    got = heightmap.height_at(torch.from_numpy(xi), torch.from_numpy(yi), 0)
    want = np.asarray(jax_hm.height_at(jnp.asarray(xi), jnp.asarray(yi), 0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    x, y = _coords(8, 40.0)
    got = heightmap.height_at(torch.from_numpy(x), torch.from_numpy(y), 2)
    want = np.asarray(jax_hm.height_at(jnp.asarray(x), jnp.asarray(y), 2))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [(0, 0), (-3, 7), (640, -585)])
def test_generate_heightmap_equal(chunk):
    """A chunk's 64 x 64 heights equal JAX's, jitted and op by op, and
    ``height_at`` of each column."""
    got = heightmap.generate_heightmap(chunk, seed=0, device="cpu")
    with jax.disable_jit():
        eager = np.asarray(jax_hm.generate_heightmap(chunk, seed=0))
    np.testing.assert_array_equal(got.numpy(), eager)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_hm.generate_heightmap(chunk, 0)))
    ys, xs = torch.meshgrid(torch.arange(64), torch.arange(64), indexing="ij")
    at = heightmap.height_at(xs + chunk[0] * 64, ys + chunk[1] * 64, 0)
    assert torch.equal(at, got)


def test_world_package_exports_the_jax_world_api():
    import raytrace_tpu.world as jax_world
    import raytrace_tpu_torch.world as world

    names = ["height_at", "generate_heightmap", "mountain_noise2", "basic_multi", "perlin2",
             *NOISE_FUNCTIONS, "mountain_noise2_grid"]
    for name in names:
        assert callable(getattr(world, name)), name
    for name in ("height_at", "generate_heightmap", "mountain_noise2", "basic_multi",
                 "perlin2"):
        assert hasattr(jax_world, name), name
