"""The port's own host modules against the JAX package's.

The port keeps its own copies of ``constants``, ``materials`` (with its own
``data/materials.csv``), ``utils/blue_noise``, ``utils/coords``,
``utils/perf``, ``engine/controls``, ``engine/game`` and the C++ source of
the host codec, so that it imports nothing of ``raytrace_tpu``.  These
hold the copies equal to the originals.
"""

from pathlib import Path

import numpy as np
import pytest

from raytrace_tpu import constants as jax_constants
from raytrace_tpu import materials as jax_materials
from raytrace_tpu.engine import controls as jax_controls
from raytrace_tpu.engine import game as jax_game
from raytrace_tpu.utils import blue_noise as jax_blue_noise
from raytrace_tpu.utils import coords as jax_coords
from raytrace_tpu.utils import perf as jax_perf
from raytrace_tpu_torch import constants, materials, native
from raytrace_tpu_torch.engine import controls, game
from raytrace_tpu_torch.utils import blue_noise, coords, perf

ROOT = Path(__file__).parent.parent


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


def test_codec_source_is_the_ports_own_copy():
    assert native.SOURCE.parent.parent.name == "raytrace_tpu_torch"
    assert native.SOURCE.read_bytes() == (ROOT / "native" / "raytrace_native.cpp").read_bytes()
    assert native.library_path().parent == ROOT / "raytrace_tpu_torch" / "build"


_BOXES = [
    ((4, 5, 6), (0, 0, 0), (1, 2, 3)),
    ((9, 9, 9), (-2, 1, 3), (2, -3, -1)),
    ((3, 3, 3), (6, 0, 0), (0, 0, 0)),  # empty after clipping
]


@pytest.mark.parametrize("box", _BOXES)
def test_coords_copies_equal(box):
    rng = np.random.default_rng(5)
    src = rng.integers(0, 99, (7, 6, 8)).astype(np.int32)
    ours, theirs = np.zeros((5, 8, 6), np.int32), np.zeros((5, 8, 6), np.int32)
    coords.copy_3d_clipped(src, ours, *box)
    jax_coords.copy_3d_clipped(src, theirs, *box)
    np.testing.assert_array_equal(ours, theirs)
    coords.fill_3d_clipped(ours, 7, box[0], box[2])
    jax_coords.fill_3d_clipped(theirs, 7, box[0], box[2])
    np.testing.assert_array_equal(ours, theirs)
    for c in [(1, 2, 3), (0, 0, 0), (15, 15, 15)]:
        assert coords.to_linear_3d(c, 16) == jax_coords.to_linear_3d(c, 16)
        lin = coords.to_linear_3d(c, 16)
        assert coords.from_linear_3d(lin, 16) == jax_coords.from_linear_3d(lin, 16) == c


def test_perf_copies_equal(monkeypatch):
    ours, theirs = perf.RingBufferAverage(3), jax_perf.RingBufferAverage(3)
    assert (ours.average(), ours.max()) == (theirs.average(), theirs.max())
    for sample in (4.0, 1.5, 9.25, 2.0, 0.5):
        ours.push_sample(sample)
        theirs.push_sample(sample)
        assert (ours.average(), ours.max()) == (theirs.average(), theirs.max())
    now = [100.0]  # both modules read time.monotonic
    monkeypatch.setattr(perf.time, "monotonic", lambda: now[0])
    trackers = perf.StatTracker(10, "chunks"), jax_perf.StatTracker(10, "chunks")
    assert trackers[0].status() == trackers[1].status()
    for n, t in ((3, 104.0), (4, 230.5)):
        now[0] = t
        for tracker in trackers:
            tracker.advance(n)
        assert trackers[0].status() == trackers[1].status()
    assert "70.0% (7/10 chunks)" in trackers[0].status()
    with perf.Timer() as timer:
        pass
    assert timer.ms >= 0.0


def _drive_controls(make):
    c = make()
    c.add_control("fwd", "w")
    c.add_control("up", "e")
    states = []
    for event, code in [("press", "w"), ("tick", None), ("press", "e"), ("release", "w"),
                        ("tick", None), ("release", "zzz"), ("release", "e"), ("tick", None)]:
        if event == "tick":
            c.tick()
        else:
            (c.on_pressed if event == "press" else c.on_released)(code)
        states.append([(c.is_held(n), c.is_pressed(n), c.is_released(n))
                       for n in ("fwd", "up", "none")])
    return states


def test_controls_copy_equal():
    assert _drive_controls(controls.ControlSet) == _drive_controls(jax_controls.ControlSet)


@pytest.mark.parametrize("args", [None, ["1", "2", "3", "0.5", "-0.25", "1.5"]])
def test_game_copy_step_for_step(args):
    """Movement and the sun, key by key, and the CLI override: the same
    floats as the JAX package's Game."""
    ours, theirs = game.Game(args), jax_game.Game(args)
    timeline = [("w", 0.25), ("d", 0.1), ("e", 0.5), ("r", 0.3), ("s", 0.2), ("q", 1.0),
                ("a", 0.05), ("f", 0.4)]
    for g in (ours, theirs):
        assert g.camera.heading == (0.5 if args else g.camera.heading)
    for key, dt in timeline:
        for g in (ours, theirs):
            g.controls.on_pressed(key)
            g.tick(dt)
            g.controls.on_released(key)
            g.controls.tick()
        assert ours.camera.origin == theirs.camera.origin, key
        assert (ours.camera.heading, ours.camera.pitch, ours.get_sun_angle()) == \
            (theirs.camera.heading, theirs.camera.pitch, theirs.get_sun_angle())
    assert ours.controls.is_held("place") is False
    ours.controls.on_pressed("b")
    assert ours.controls.is_pressed("place")
