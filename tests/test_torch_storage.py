"""The port's chunk cache against the JAX package's: the container, each
package reading the other's files, warn-and-regenerate, the shared
directory, and the cache-streamed volume against the device-streamed one.

The chunks are cut from the ``full_world_volume`` fixture (world
[-128, 128)^3, the streamer's initial region); only the slab beyond it is
generated.
"""

import numpy as np
import pytest
import torch

from raytrace_tpu.world import storage as jax_storage
from raytrace_tpu_torch import native
from raytrace_tpu_torch.render.pipeline import Pipeline
from raytrace_tpu_torch.render.streaming import AXIS_X, TerrainStreamer
from raytrace_tpu_torch.utils.coords import copy_3d_clipped
from raytrace_tpu_torch.world import storage
from raytrace_tpu_torch.world.generate import generate_chunk

CODECS = ["lz4", "zlib"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: the suite runs several workers
    on one machine's cores, where eight threads a worker thrash."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _chunk(full_world_volume, coord):
    """(materials uint32, minefield uint8) of a chunk of the fixture."""
    mats, mf = full_world_volume
    sl = tuple(slice((c + 2) * 64, (c + 3) * 64) for c in reversed(coord))
    return mats[sl], mf[sl]


def _codec(monkeypatch, codec):
    if codec == "zlib":
        monkeypatch.setattr(storage, "lz4_available", lambda: False)
        monkeypatch.setattr(jax_storage, "lz4_available", lambda: False)
    else:
        assert native.lz4_available(), native.build_error
    return b"RTL4" if codec == "lz4" else b"RTZL"


@pytest.mark.parametrize("codec", CODECS)
def test_encode_is_byte_equal_to_jax(full_world_volume, monkeypatch, codec):
    """The same container bytes from the JAX package's uint32 words and from
    the port's int32 view of them."""
    magic = _codec(monkeypatch, codec)
    mats, mf = _chunk(full_world_volume, (0, -1, 0))  # the terrain surface
    assert mats.any()
    want = jax_storage.ChunkStorage._encode(mats, mf)
    assert want[:4] == magic
    assert storage.ChunkStorage._encode(mats, mf) == want
    assert storage.ChunkStorage._encode(mats.view(np.int32), mf) == want


@pytest.mark.parametrize("codec", CODECS)
def test_each_package_reads_the_others_file(full_world_volume, monkeypatch, tmp_path, codec):
    _codec(monkeypatch, codec)
    ours = storage.ChunkStorage(tmp_path / "port", seed=0, device="cpu")
    theirs = jax_storage.ChunkStorage(tmp_path / "jax", seed=0)
    for coord in [(-1, 0, 0), (1, -2, 0)]:
        assert ours.path_for(coord).name == theirs.path_for(coord).name
        mats, mf = _chunk(full_world_volume, coord)
        theirs.path_for(coord).write_bytes(theirs._encode(mats, mf))
        ours.path_for(coord).write_bytes(ours._encode(mats.view(np.int32), mf))
        got_m, got_f = storage.ChunkStorage(tmp_path / "jax", device="cpu") \
            .borrow_packed_chunk_data(coord)
        assert got_m.dtype == np.int32 and got_m.shape == (64, 64, 64)
        np.testing.assert_array_equal(got_m.view(np.uint32), mats)
        np.testing.assert_array_equal(got_f, mf)
        got_m, got_f = jax_storage.ChunkStorage(tmp_path / "port").borrow_packed_chunk_data(coord)
        np.testing.assert_array_equal(got_m, mats)
        np.testing.assert_array_equal(got_f, mf)


def test_corrupt_file_warns_and_regenerates(tmp_path, capsys):
    store = storage.ChunkStorage(tmp_path, seed=0, device="cpu")
    coord = (0, 0, -1)
    want_m, want_f = (t.numpy() for t in generate_chunk(coord, seed=0, device="cpu"))
    store.path_for(coord).write_bytes(b"garbage!")
    got_m, got_f = store.borrow_packed_chunk_data(coord)
    assert "WARNING: Failed to read chunk data" in capsys.readouterr().out
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_array_equal(got_f, want_f)
    assert store.path_for(coord).read_bytes()[:4] == b"RTL4"  # rewritten
    np.testing.assert_array_equal(store.borrow_packed_chunk_data(coord)[0], want_m)
    assert capsys.readouterr().out == ""


def test_default_storage_dir_is_the_jax_packages(monkeypatch, tmp_path):
    monkeypatch.setenv("RAYTRACE_TPU_HOME", str(tmp_path / "home"))
    assert storage.default_storage_dir() == jax_storage.default_storage_dir() \
        == tmp_path / "home" / "world"
    monkeypatch.delenv("RAYTRACE_TPU_HOME")
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "xdg"))
    assert storage.default_storage_dir() == jax_storage.default_storage_dir() \
        == tmp_path / "xdg" / "raytrace_tpu" / "world"


@pytest.mark.parametrize("box", [
    ((64, 64, 64), (0, 0, 0), (-10, 5, 20)),
    ((64, 64, 64), (5, -7, 9), (-11, 13, -3)),
    ((16, 256, 256), (0, 0, 0), (-48, 0, 0)),
    ((8, 8, 8), (0, 0, 0), (60, 60, 60)),
])
def test_copy3d_equals_copy_3d_clipped(box):
    rng = np.random.default_rng(1)
    for dtype in (np.int32, np.uint8):
        src = rng.integers(0, 200, (64, 64, 64)).astype(dtype)
        got = np.zeros((40, 48, 56), dtype)
        want = got.copy()
        native.copy3d(src, got, *box)
        copy_3d_clipped(src, want, *box)
        np.testing.assert_array_equal(got, want)


def _cache_of_fixture(full_world_volume, path):
    """A cache holding the 64 chunks of the fixture (the initial region)."""
    store = storage.ChunkStorage(path, seed=0, device="cpu")
    for cz in range(-2, 2):
        for cy in range(-2, 2):
            for cx in range(-2, 2):
                mats, mf = _chunk(full_world_volume, (cx, cy, cz))
                store.path_for((cx, cy, cz)).write_bytes(store._encode(mats, mf))
    return store


def test_cache_streamer_equals_device_streamer(full_world_volume, tmp_path):
    """Initialized from the cache, the volume is the device-generated one
    bit for bit; after one +x slice move (its 16 chunks are cache misses,
    generated and stored) it still is."""
    store = _cache_of_fixture(full_world_volume, tmp_path)
    cache = TerrainStreamer(seed=0, device="cpu", source="cache", storage=store)
    device = TerrainStreamer(seed=0, device="cpu")
    assert torch.equal(cache.initialize(), device.initialize())
    for s in (cache, device):
        s.drain_slab_log()
        s.request_increase(AXIS_X)
        assert s.setup_next_request()
    assert torch.equal(cache.volume, device.volume)
    assert cache.drain_slab_log() == device.drain_slab_log() == [(2, 0)]
    assert len(list(tmp_path.iterdir())) == 64 + 16
    assert all(store.has_chunk((2, cy, cz)) for cy in range(-2, 2) for cz in range(-2, 2))


def test_cache_source_rules(full_world_volume, tmp_path):
    """Pipeline passes source and storage to its streamer; the heightfield
    tracers read no chunk; teleport needs the device source, as in JAX."""
    store = storage.ChunkStorage(tmp_path, seed=0, device="cpu")
    fused = Pipeline(width=8, height=8, device="cpu", source="cache", storage=store)
    assert fused.streamer.source == "cache" and fused.streamer.storage is store
    fused.converge_streaming((40, 0, 0))
    assert fused.streamer.volume is None and not list(tmp_path.iterdir())
    with pytest.raises(ValueError, match="teleport needs the device source"):
        fused.streamer.teleport((0.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="needs a ChunkStorage"):
        TerrainStreamer(device="cpu", source="cache")
    with pytest.raises(ValueError, match="unknown terrain source"):
        TerrainStreamer(device="cpu", source="disk")


def test_storage_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present; the no-GPU refusal cannot be shown")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        storage.ChunkStorage(tmp_path)
