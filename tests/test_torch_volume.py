"""The port's volume world against the JAX package: fused format,
minefield, worldgen, occupancy tables, the streaming data plane and edits.

Worldgen is bit-exact with the JAX functions run op by op
(``jax.disable_jit``); the tables and edits are exact on the same input
volume.  The JAX streamer generates under ``jit``, whose heights can differ
from the op-by-op ones by one in a few columns (``tests/test_torch_world.py``),
so the streamer comparison allows a bound on differing columns.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytrace_tpu.materials import PACKED_MATERIALS
from raytrace_tpu.ops import trace_jax as jax_trace
from raytrace_tpu.ops import trace_vol_pallas as jax_vol
from raytrace_tpu.render.streaming import TerrainStreamer as JaxStreamer
from raytrace_tpu.world import chunk as jax_chunk
from raytrace_tpu.world import edit as jax_edit
from raytrace_tpu.world import generate as jax_gen
from raytrace_tpu_torch import convert
from raytrace_tpu_torch.ops import vol_tables, volume
from raytrace_tpu_torch.render.streaming import TerrainStreamer
from raytrace_tpu_torch.world import chunk, edit, generate

CHUNK_ORIGINS = [(0, 0, 0), (-64, 128, -64), (-256, -64, 0), (640, -1280, 64)]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _weird_solid():
    """Slab + floating box + cave tunnel (tests/test_path_vol.py:38-47)."""
    solid = np.zeros((256, 256, 256), bool)
    solid[:100] = True
    solid[140:150, 120:140, 120:140] = True
    solid[90:100, 128:132, 128:132] = False
    return solid


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: the suite runs several workers
    on one machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weird():
    """The weird scene as JAX fused volume + tables and the port's volume."""
    solid = _weird_solid()
    mats = np.where(solid, np.uint32(PACKED_MATERIALS[5]), np.uint32(0))
    fused = jax_trace.fuse_volume(
        jnp.asarray(mats), jax_chunk.minefield_from_solid(jnp.asarray(solid)))
    return fused, jax_vol.build_vol_tables(fused), convert.volume_from_jax(fused, "cpu")


@pytest.fixture(scope="module")
def full_world(full_world_volume):
    mats, mf = full_world_volume
    fused = jax_trace.fuse_volume(jnp.asarray(mats), jnp.asarray(mf))
    return fused, jax_vol.build_vol_tables(fused), convert.volume_from_jax(fused, "cpu")


@pytest.mark.parametrize("origin", CHUNK_ORIGINS)
def test_generate_box_exact(origin):
    with jax.disable_jit():
        want = jax_gen.generate_box(origin, (64, 64, 64), seed=0)
        want_fused = np.asarray(jax_trace.fuse_volume(want["materials"], want["minefield"]))
    got = generate.generate_box(origin, (64, 64, 64), seed=0, device="cpu")
    np.testing.assert_array_equal(_u32(got["materials"]), np.asarray(want["materials"]))
    np.testing.assert_array_equal(got["solid"].numpy(), np.asarray(want["solid"]))
    np.testing.assert_array_equal(got["minefield"].numpy(), np.asarray(want["minefield"]))
    fused = volume.fuse_volume(got["materials"], got["minefield"])
    np.testing.assert_array_equal(_u32(fused), want_fused)


def test_generate_chunk_exact():
    with jax.disable_jit():
        want = jax_gen.generate_chunk((-1, 2, 0), seed=3)
    got = generate.generate_chunk((-1, 2, 0), seed=3, device="cpu")
    np.testing.assert_array_equal(_u32(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_minefield_and_pack_chunk_exact():
    rng = np.random.default_rng(5)
    solid = np.repeat(rng.random((16, 8, 8)) < 0.05, 8, 0).repeat(8, 1).repeat(8, 2)
    solid[:, :, 40:] = False  # a chunk-sized empty region -> step 6
    solid[3, 5, 7] = True
    want = np.asarray(jax_chunk.minefield_from_solid(jnp.asarray(solid)))
    got = chunk.minefield_from_solid(torch.from_numpy(solid))
    np.testing.assert_array_equal(got.numpy(), want)
    mats = torch.from_numpy(np.where(solid, 7, 0).astype(np.int32))
    packed, mf = chunk.pack_chunk(torch.from_numpy(solid), mats)
    assert packed is mats and torch.equal(mf, got)
    with pytest.raises(ValueError, match="64-multiple"):
        chunk.minefield_from_solid(torch.zeros(64, 64, 32, dtype=torch.bool))


def test_lookup_is_toroidal(full_world):
    fused, _, port = full_world
    pos = np.random.default_rng(2).uniform(-400, 400, (4096, 3)).astype(np.float32)
    pos[:4] = [[-128.0, -128.0, -128.0], [127.99, 0.0, -0.0], [-1e-9, 3.5, 255.0],
               [-256.5, 511.0, 0.25]]
    want = np.asarray(jax_trace._lookup(fused, jnp.asarray(pos)))
    got = volume.lookup(port, torch.from_numpy(pos))
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("scene", ["full_world", "weird"])
def test_build_vol_tables_exact(scene, request):
    fused, want, port = request.getfixturevalue(scene)
    got = vol_tables.build_vol_tables(port)
    for key in vol_tables.TABLE_KEYS:
        w = np.asarray(want[key])
        assert tuple(got[key].shape) == w.shape, key
        assert got[key].numpy().dtype == w.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)


@pytest.mark.parametrize("arr_axis", [0, 1, 2])
def test_update_vol_tables_equals_rebuild(weird, full_world, arr_axis):
    """A 16-texel slab of the generated world written into the weird scene
    (along each array axis, at a texel start that is not brick-plane 0)."""
    _, _, base = weird
    _, _, world = full_world
    t = 48 if arr_axis != 1 else 112
    new = base.clone()
    new.view(256, 256, 256).narrow(arr_axis, t, 16).copy_(
        world.view(256, 256, 256).narrow(arr_axis, t, 16))
    before = vol_tables.build_vol_tables(base)
    got = vol_tables.update_vol_tables(before, new, t, arr_axis)
    want = vol_tables.build_vol_tables(new)
    for key in vol_tables.TABLE_KEYS:
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(before["detail"], vol_tables.build_vol_tables(base)["detail"])


# Slabs written one after another: (array axis, texel start).  Texels 8 and
# 120 put a slab's two brick planes in two 16-level planes.
UPDATE_SLABS = [[(axis, t)] for axis in (0, 1, 2) for t in (8, 120)] + [[(2, 240), (0, 8)]]


@pytest.mark.parametrize("slabs", UPDATE_SLABS, ids=lambda slabs: "+".join(
    f"axis{axis}_t{t}" for axis, t in slabs))
def test_update_vol_tables_matches_jax(weird, full_world, slabs):
    """Slabs of the generated world written into the weird scene one after
    another: the port's update, table for table after each slab, is JAX's
    jitted ``update_vol_tables`` of the same tables and volume."""
    _, want, base = weird
    _, _, world = full_world
    got, volume = vol_tables.build_vol_tables(base), base.clone()
    for axis, t in slabs:
        volume.view(256, 256, 256).narrow(axis, t, 16).copy_(
            world.view(256, 256, 256).narrow(axis, t, 16))
        want = jax_vol.update_vol_tables(
            want, jnp.asarray(volume.numpy().view(np.uint32)), t, axis)
        got = vol_tables.update_vol_tables(got, volume, t, axis)
        for key in vol_tables.TABLE_KEYS:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                          err_msg=f"{key} after {(axis, t)}")


# O1's grid per brick box ((first, count) along z, y, x): each slab gives
# the H100's 132 SMs a block; a build keeps 2,048 blocks.
O1_GRIDS = [([(30, 2), (0, 32), (0, 32)], 256), ([(0, 32), (1, 2), (0, 32)], 256),
            ([(0, 32), (0, 32), (30, 2)], 256), ([(0, 32), (0, 32), (3, 2)], 256),
            ([(0, 32)] * 3, 2048)]


@pytest.mark.parametrize("box, blocks", O1_GRIDS)
def test_vol_tables_launch_grid(box, blocks):
    grid = vol_tables.launch_grid(box)
    assert grid == dict(blocks=(blocks, 1), threads=vol_tables.BLOCK_THREADS)
    assert blocks >= 132


@pytest.mark.parametrize("lr", [(0, 0, 0), (5, -3, 17), (-32, 0, 64), (130, 0, -7)])
def test_occupancy_world_bounds_exact(weird, lr):
    _, tables, _ = weird
    want = jax_vol._occupancy_world_bounds(tables["any8b"], jnp.asarray(lr, jnp.int32))
    got = vol_tables.occupancy_world_bounds(
        torch.from_numpy(np.array(tables["any8b"])), torch.tensor(lr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_occupancy_world_bounds_empty_volume_is_inverted():
    empty = np.zeros((32, 32, 32), bool)
    lr = (3, 0, -9)
    want = np.asarray(jax_vol._occupancy_world_bounds(jnp.asarray(empty),
                                                      jnp.asarray(lr, jnp.int32)))
    got = vol_tables.occupancy_world_bounds(torch.from_numpy(empty), torch.tensor(lr))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0::2] > got[1::2]).all()


def _differing_columns(got: torch.Tensor, want) -> float:
    got = got.numpy().view(np.uint32).reshape(256, 256, 256)
    columns = (got != np.asarray(want).reshape(256, 256, 256)).any(0)
    print(f"{int(columns.sum())} of {columns.size} columns differ")
    return float(columns.mean())


def test_streamer_volume_matches_jax(full_world):
    """Initialize, teleport, then slice moves up and down two axes: the
    same volume as the jitted JAX worldgen (a few columns may differ), and
    the same positions and slab log as the JAX streamer."""
    ours, theirs = TerrainStreamer(seed=0, device="cpu"), JaxStreamer(seed=0)
    assert _differing_columns(ours.initialize(), full_world[0]) <= 0.001
    ours.teleport((-30.0, 0.0, 60.0))
    theirs.teleport((-30.0, 0.0, 60.0))
    assert ours.drain_slab_log() is None and theirs.drain_slab_log() is None
    for target in [(40, 0, 60)] * 2 + [(0, 0, 100)] + [(-60, 0, 100)]:
        ours.request_move_towards(target)
        theirs.request_move_towards(target)
        assert ours.setup_next_request() and theirs.setup_next_request()
    assert ours.get_render_offset() == theirs.get_render_offset() == (-16, 0, 80)
    assert ours.drain_slab_log() == theirs.drain_slab_log() == [
        (2, 224), (2, 240), (0, 64), (2, 240)]
    assert _differing_columns(ours.volume, theirs.volume) <= 0.001


def test_streamer_initialize_takes_a_private_copy(weird):
    _, _, port = weird
    s = TerrainStreamer(device="cpu")
    vol = s.initialize(port.numpy().view(np.uint32))
    assert vol.dtype == torch.int32 and torch.equal(vol, port)
    s.request_move_towards((40, 0, 0))
    s.setup_next_request()
    assert not torch.equal(s.volume, port)
    assert s.drain_slab_log() is None  # initialize replaced the volume
    assert s.drain_slab_log() == []


def test_streamer_without_volume_moves_positions_only():
    s = TerrainStreamer(device="cpu")
    s.request_move_towards((40, 0, 0))
    assert s.setup_next_request() and s.volume is None
    assert s.get_render_offset() == (16, 0, 0)
    with pytest.raises(RuntimeError, match="resident volume"):
        s.edit_box((0, 0, 0), (1, 1, 1), 2)


_EDITS = {
    "solid_resident": ((0, 0, 0), (-20, 10, 12), (24, 6, 10), 3),
    "carve_resident": ((0, 0, 0), (-8, -8, -80), (16, 16, 30), None),
    "solid_straddling": ((16, 0, 0), (-100, 0, 120), (8, 8, 4), 1),
    "carve_straddling": ((16, 0, 0), (-112, -70, -40), (40, 20, 12), None),
}


@pytest.mark.parametrize("case", list(_EDITS))
def test_edit_fused_volume_exact(weird, case):
    fused, _, port = weird
    window, mins, shape, material = _EDITS[case]
    want = np.asarray(jax_edit.edit_fused_volume(fused, window, mins, shape, material))
    got = edit.edit_fused_volume(port, window, mins, shape, material)
    np.testing.assert_array_equal(_u32(got), want)
    assert not np.array_equal(want, np.asarray(fused))


def test_edit_validation(weird):
    _, _, port = weird
    with pytest.raises(ValueError, match="outside the resident window"):
        edit.edit_fused_volume(port, (0, 0, 0), (120, 0, 0), (16, 1, 1), 2)
    with pytest.raises(ValueError, match="empty edit box"):
        edit.edit_fused_volume(port, (0, 0, 0), (0, 0, 0), (0, 1, 1), 2)
    with pytest.raises(ValueError, match="unknown material"):
        edit.edit_fused_volume(port, (0, 0, 0), (0, 0, 0), (1, 1, 1), 99)
