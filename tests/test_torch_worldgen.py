"""Kernel G1's plain version (``ops/worldgen.py``) and kernel O1's wrappers
(``ops/vol_tables.py``) against the JAX package and the port's old paths.

G1's plain version computes a box's words from its columns (heights over
the 32-aligned column tiles, their 2- to 32-column maxima, then each
voxel's step and material); it must equal JAX's ``generate_box`` run op by
op (``jax.disable_jit``) over the box's 64-aligned enclosure, sliced, word
for word, and ``generate_into`` on a CPU volume must equal the old
enclosure-and-roll path (``testing/enclosure.py``) on every streamed box.
``generate_box`` on the CPU (its plain version) and the formulation of
G1's box mode (``box_plain``) must equal JAX's ``generate_box`` op by op,
materials, minefield and solid.  The kernels themselves run on the card
only: ``chip_smoke.py`` (``worldgen_kernel``, ``generate_box_kernel``,
``vol_tables_kernel``) holds them against these plain versions.
"""

import numpy as np
import pytest
import torch

import jax

from raytrace_tpu.ops import trace_jax as jax_trace
from raytrace_tpu.world import generate as jax_gen
from raytrace_tpu_torch.ops import vol_tables, worldgen
from raytrace_tpu_torch.ops.volume import MATERIAL_MASK, STEP_SHIFT
from raytrace_tpu_torch.render.pipeline import Pipeline
from raytrace_tpu_torch.render.camera import Camera
from raytrace_tpu_torch.render.streaming import TerrainStreamer
from raytrace_tpu_torch.testing import enclosure
from raytrace_tpu_torch.world import generate

# World boxes (label, w0 xyz, shape xyz, seed), each inside one 64^3 chunk
# so that JAX's enclosure stays 64^3: slabs along x, y and z, at negative
# origins, below z = 0, at +-2^20, and at the offset of slice 15.
JAX_BOXES = [
    ("x_slab", (48, -48, 16), (16, 32, 32), 0),
    ("y_slab_negative", (-112, -16, 16), (32, 16, 32), 7),
    ("z_slab", (16, 16, 96), (32, 32, 16), 0),
    ("z_slab_below_0", (-48, 80, -16), (32, 32, 16), 7),
    ("x_slab_2e20", ((1 << 20) + 16, -(1 << 20) + 32, 0), (16, 32, 32), 7),
    ("y_slab_minus_2e20", (-(1 << 20) + 32, (1 << 20) + 48, 32), (32, 16, 32), 0),
    ("x_slab_ns15", (112, -112, 48), (16, 32, 16), 7),
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several workers on one
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_box_words(w0, shape, seed) -> np.ndarray:
    """JAX's fused words of the box, op by op: ``generate_box`` over the
    64-aligned enclosure, sliced -> (Z, Y, X) uint32."""
    aligned = [v - v % 64 for v in w0]
    ext = [-(-(w + s - a) // 64) * 64 for w, s, a in zip(w0, shape, aligned)]
    with jax.disable_jit():
        box = jax_gen.generate_box(tuple(aligned), tuple(ext), seed=seed)
        fused = np.asarray(jax_trace.fuse_volume(box["materials"], box["minefield"]))
    fused = fused.reshape(ext[2], ext[1], ext[0])
    s = [w - a for w, a in zip(w0, aligned)]
    return fused[s[2]:s[2] + shape[2], s[1]:s[1] + shape[1], s[0]:s[0] + shape[0]]


@pytest.mark.parametrize("label,w0,shape,seed", JAX_BOXES, ids=[b[0] for b in JAX_BOXES])
def test_box_words_plain_matches_jax(label, w0, shape, seed):
    want = _jax_box_words(w0, shape, seed)
    got = worldgen.box_words_plain(w0, shape, seed, "cpu").numpy().view(np.uint32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got & MATERIAL_MASK, want & MATERIAL_MASK,
                                  err_msg="materials")
    np.testing.assert_array_equal(got >> STEP_SHIFT, want >> STEP_SHIFT, err_msg="minefield")
    np.testing.assert_array_equal(got, want)
    assert 0 < (got >> STEP_SHIFT).max() or label == "z_slab_below_0"


@pytest.mark.parametrize("case", enclosure.STREAM_CASES, ids=[c[0] for c in enclosure.STREAM_CASES])
def test_generate_into_matches_the_enclosure_path(case):
    """Every streamed box (slabs on each axis both ways, wrapping texel
    ranges, +-2^20, a teleport's region, the initial region) written into a
    CPU volume: word for word the old path's volume."""
    label, origin, ns, axis, seed = case
    base = torch.arange(256 ** 3, dtype=torch.int32)  # every word distinct
    w0, shape = enclosure.stream_box(origin, ns, axis)
    want = enclosure.stream_old(base.clone(), origin, ns, axis, seed)
    volume = base.clone()
    launches = worldgen.generate_into.launches
    got = worldgen.generate_into(volume, w0, shape, seed)
    assert got is volume and torch.equal(got, want)
    assert worldgen.generate_into.launches == launches  # the CPU takes the plain version


def test_generate_into_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="extents"):
        worldgen.generate_into(torch.zeros(256 ** 3, dtype=torch.int32), (0, 0, 0),
                               (16, 257, 16))
    meta = torch.empty(256 ** 3, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        worldgen.generate_into(meta, (0, 0, 0), (16, 16, 16))
    with pytest.raises(RuntimeError, match="no kernel"):
        vol_tables.build_vol_tables(meta)


# generate_box's boxes (label, origin xyz, shape xyz, seed): a chunk at a
# negative origin, an x-row of two chunks, an all-solid chunk (z < 0) and
# an all-air chunk (high z).
GENERATE_BOXES = [
    ("chunk_negative", (-128, -64, 0), (64, 64, 64), 7),
    ("x_row", (-64, 64, 0), (128, 64, 64), 0),
    ("all_solid", (64, -64, -128), (64, 64, 64), 7),
    ("all_air", (0, 0, 512), (64, 64, 64), 0),
]


@pytest.fixture(scope="module", params=GENERATE_BOXES, ids=[b[0] for b in GENERATE_BOXES])
def jax_box(request):
    """(label, origin, shape, seed, JAX's generate_box op by op)."""
    label, origin, shape, seed = request.param
    with jax.disable_jit():
        box = jax_gen.generate_box(origin, shape, seed=seed)
        return label, origin, shape, seed, {k: np.asarray(v) for k, v in box.items()}


def _check_box(got: dict, want: dict, label: str, shape) -> None:
    zyx = tuple(reversed(shape))
    assert set(got) == {"materials", "solid", "minefield"}
    assert got["materials"].dtype == torch.int32 and got["solid"].dtype == torch.bool
    assert got["minefield"].dtype == torch.uint8
    for k in got:
        assert tuple(got[k].shape) == zyx, k
    np.testing.assert_array_equal(got["materials"].numpy().view(np.uint32),
                                  want["materials"], err_msg="materials")
    np.testing.assert_array_equal(got["minefield"].numpy(), want["minefield"],
                                  err_msg="minefield")
    np.testing.assert_array_equal(got["solid"].numpy(), want["solid"], err_msg="solid")
    solid = want["solid"]
    assert solid.all() if label == "all_solid" else (
        not solid.any() if label == "all_air" else 0 < solid.mean() < 1)


def test_generate_box_on_the_cpu_matches_jax(jax_box):
    """``generate_box`` on the CPU is the plain version, word for word
    JAX's ``generate_box`` run op by op, and launches nothing."""
    label, origin, shape, seed, want = jax_box
    launches = generate.generate_box.launches
    got = generate.generate_box(origin, shape, seed=seed, device="cpu")
    assert generate.generate_box.launches == launches
    _check_box(got, want, label, shape)
    plain = generate.generate_box_plain(origin, shape, seed=seed)
    assert all(torch.equal(got[k], plain[k]) for k in got)


def test_box_mode_formulation_matches_jax(jax_box):
    """The formulation G1's box mode computes (``box_words_plain`` split
    into the three outputs, ``worldgen.box_plain``) equals JAX's
    ``generate_box`` word for word."""
    label, origin, shape, seed, want = jax_box
    _check_box(worldgen.box_plain(origin, shape, seed, "cpu"), want, label, shape)


def test_generate_box_refuses_what_no_kernel_takes():
    """A box that is not 64-aligned raises ``ValueError`` on every device;
    a device with no kernel (neither CPU nor CUDA) raises."""
    for origin, shape in (((32, 0, 0), (64, 64, 64)), ((0, 0, 0), (64, 96, 64)),
                          ((0, 0, 0), (0, 64, 64)), ((0, 0), (64, 64, 64))):
        for device in ("cpu", "meta"):
            with pytest.raises(ValueError, match="64-aligned"):
                generate.generate_box(origin, shape, device=device)
    with pytest.raises(RuntimeError, match="no kernel"):
        generate.generate_box((0, 0, 0), (64, 64, 64), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        generate.generate_chunk((0, 0, 0), device="meta")


@pytest.fixture(scope="module")
def world_words(full_world_volume):
    mats, mf = full_world_volume
    words = (mats | (mf.astype(np.uint32) << STEP_SHIFT)).reshape(-1).view(np.int32)
    return torch.from_numpy(words.copy())


@pytest.mark.parametrize("arr_axis", [0, 1, 2])
def test_vol_tables_out_equals_the_functional_forms(world_words, arr_axis):
    """``build_vol_tables(out=)`` and ``update_vol_tables(out=)`` (into other
    buffers and in place) equal the functional forms, which leave their
    input tables as they were."""
    base = world_words
    fresh = vol_tables.empty_vol_tables("cpu")
    built = vol_tables.build_vol_tables(base, out=fresh)
    want = vol_tables.build_vol_tables(base)
    assert built is fresh
    for k in vol_tables.TABLE_KEYS:
        assert torch.equal(built[k], want[k]), k
    t = 240 if arr_axis != 1 else 64
    new = base.clone()
    new.view(256, 256, 256).narrow(arr_axis, t, 16).fill_(6 << STEP_SHIFT)  # carve air
    kept = {k: v.clone() for k, v in want.items()}
    functional = vol_tables.update_vol_tables(want, new, t, arr_axis)
    other = vol_tables.update_vol_tables(want, new, t, arr_axis,
                                         out=vol_tables.empty_vol_tables("cpu"))
    in_place = {k: v.clone() for k, v in want.items()}
    same_dict = vol_tables.update_vol_tables(in_place, new, t, arr_axis, out=in_place)
    rebuilt = vol_tables.build_vol_tables(new)
    assert same_dict is in_place
    for k in vol_tables.TABLE_KEYS:
        assert torch.equal(want[k], kept[k]), k
        for got in (functional, other, in_place):
            assert torch.equal(got[k], rebuilt[k]), k
    assert not torch.equal(rebuilt["any8b"], kept["any8b"])
    with pytest.raises(ValueError, match="no slab"):
        vol_tables.update_vol_tables(want, new, 4, arr_axis)


def test_streamer_keeps_its_volume_storage():
    """A slab, a teleport, an edit and a re-initialize write the same
    storage, each with the volume the old path would hold."""
    s = TerrainStreamer(seed=7, device="cpu")
    volume = s.initialize()
    ptr = volume.data_ptr()
    want = enclosure.stream_old(torch.empty_like(volume), (-2, -2, -2), (0, 0, 0), None, 7)
    assert torch.equal(volume, want)
    s.request_move_towards((40, 0, 0))
    assert s.setup_next_request()
    s.teleport((600.0, 0.0, -300.0))
    origin, ns = s.gpu_position.origin, s.gpu_position.num_loaded_slices
    assert torch.equal(s.volume, enclosure.stream_old(volume, origin, ns, None, 7))
    s.edit_box((590, 0, -310), (4, 4, 4), 2)
    s.initialize()
    assert s.volume.data_ptr() == ptr


def test_pipeline_keeps_its_volume_and_table_storage():
    """The volume_fast pipeline's volume and occupancy tables are the frame
    program's buffers from the first frame on, and stay so across a slab,
    an edit, a teleport and a re-initialize: no world copy on refresh."""
    p = Pipeline(width=8, height=8, device="cpu", tracer="volume_fast")
    cam = Camera(origin=[8.0, -100.0, 14.0], pitch=-0.05)
    p.draw_frame(cam, 0.6)
    volume, tables = p.streamer.volume, p.vol_tables()
    ptrs = [volume.data_ptr(), *(tables[k].data_ptr() for k in vol_tables.TABLE_KEYS)]
    program = next(iter(p._programs.values()))
    assert program.world[0] is volume and program.world[1] is tables

    def step(event):
        if event == "edit":
            p.edit_box((-10, -70, 0), (20, 4, 20), 5)
        elif event == "teleport":
            cam.origin = [700.0, -100.0, 14.0]
            p.teleport(cam)
        elif event == "initialize":
            p.streamer.initialize()
        else:
            cam.origin[0] += 40.0
        p.draw_frame(cam, 0.6)
        now = [p.streamer.volume.data_ptr(),
               *(p.vol_tables()[k].data_ptr() for k in vol_tables.TABLE_KEYS)]
        assert now == ptrs, event
        want = vol_tables.build_vol_tables(p.streamer.volume)
        for k in vol_tables.TABLE_KEYS:
            assert torch.equal(p.vol_tables()[k], want[k]), (event, k)

    for event in ("slab", "edit", "teleport", "initialize"):
        step(event)
