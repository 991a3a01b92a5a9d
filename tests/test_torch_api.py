"""The port answers JAX's calls.

One case per public function, class and method of the JAX package that
has a counterpart in the port (the same name at the same module path, or
in the port module that holds its work: ``PORT_MODULES``, ``RENAMED``),
held to one rule.  Every call that JAX's signature accepts must, in the
port, either

- bind every parameter the two share to the same name, with the same
  default (or the port's own default, where ``OWN_DEFAULTS`` says why), or
- raise ``TypeError``, and only where the call reaches a parameter that is
  left out by design (``LEFT_OUT_PARAMS``).

The calls are made from JAX's ``inspect.signature``: a sentinel for every
parameter, passed by position for each count of positional arguments JAX
takes and by keyword one at a time, and both signatures bind them.  A JAX
function with no counterpart fails unless ``LEFT_OUT_NAMES`` lists it.

Then the calls that follow from it, on the CPU at 16²-32² with torch on two
threads: ``render_frame`` with a uniforms dict and ``with_gbuffers``
against ``render_frame_packed`` and against JAX's ``render_frame`` for
the four tracers (``lr.y`` 0 and not); ``Pipeline`` by
position in JAX's order and ``create_instance``; ``generate_box`` without
the minefield on unaligned boxes against JAX's; ``draw_frame``'s
reprojection fields; and the entry points that run on the card unless
given a device, which raise without one.
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raytrace_tpu
import raytrace_tpu_torch
from raytrace_tpu.ops.trace_jax import fuse_volume
from raytrace_tpu.ops.trace_pallas import build_hf_tables as jax_build_hf_tables
from raytrace_tpu.ops.trace_vol_pallas import build_vol_tables as jax_build_vol_tables
from raytrace_tpu.render import pipeline as jax_pipeline
from raytrace_tpu.world import generate as jax_gen
from raytrace_tpu_torch import convert
from raytrace_tpu_torch.ops.hf_tables import build_hf_tables, with_column_heights
from raytrace_tpu_torch.ops.vol_tables import build_vol_tables
from raytrace_tpu_torch.render import pipeline
from raytrace_tpu_torch.render.camera import Camera
from raytrace_tpu_torch.testing.golden import compare_images
from raytrace_tpu_torch.utils.blue_noise import get_blue_noise_f32
from raytrace_tpu_torch.world import generate, heightmap, noise

# JAX modules whose work lies in port modules of other names: the Pallas
# kernels' modules and the plain-JAX tracer.
PORT_MODULES = {
    "ops.lighting_pallas": ("ops.lighting",),
    "ops.trace_pallas": ("ops.trace_hf", "ops.hf_tables"),
    "ops.trace_vol_pallas": ("ops.trace_vol", "ops.vol_tables"),
    "ops.denoise_pallas": ("ops.denoise",),
    "ops.trace_jax": ("ops.trace_dda", "ops.rays", "ops.integrate", "ops.volume"),
}
# JAX functions whose counterpart has another name.
RENAMED = {
    "ops.denoise_pallas.denoise_chain_pallas": "ops.denoise.denoise_chain",
    "ops.denoise_pallas.denoise_finalize_pallas": "ops.denoise.denoise_finalize",
}

# The allow-list: what the port leaves out by design, and why.  Nothing
# else of JAX's public API may be missing.
LEFT_OUT_NAMES = {
    # The NumPy oracles: only tests call them, and tests import JAX's.
    "ops.denoise.bilateral_denoise_np": "NumPy oracle",
    "ops.finalize.finalize_frame_np": "NumPy oracle",
    # XLA's scoped-VMEM compiler options for the TPU's striped denoise.
    "ops.denoise_pallas.scoped_vmem_options": "TPU compiler option",
    # TPU workarounds: K3s resolves a parked ray inside its march.
    "ops.trace_vol_pallas.resolve_mixed": "TPU workaround",
    "ops.trace_vol_pallas.resolve_mixed_parallel": "TPU workaround",
    # A jax.sharding mesh: the tile split takes a torch.distributed group.
    "parallel.tiles.make_tile_mesh": "JAX mesh",
}
# Parameters left out wherever JAX has them: the TPU-only knobs of the
# Pallas kernels (tiling, interpret mode, the unified kernel, unrolling,
# the lazy t, the tail's rows, the reference state, the straggler cascade,
# the mixed resolve, the safety drain, the round schedule's levels), the
# array module of ops/shading.py (the port computes on tensors) and the
# tile split's mesh (the port takes a torch.distributed group).
LEFT_OUT_PARAMS = {
    name: "TPU knob" for name in (
        "interpret", "tile_rows", "unified", "unroll", "lazy_t", "tail_rows",
        "ref_state", "cascade", "resolve", "safety", "safety_R", "levels")
} | {"xp": "array module", "mesh": "JAX mesh"}
# Parameters left out of one function: the TPU cascade's and round
# schedule's budgets, where the port gives each ray or path one budget.
# (``render_gbuffers_hf``'s and ``trace_rays_hf``'s ``caps`` stay: they only
# add to the bounce batches' budget, which K4 takes whole, ``hf_budget``;
# tests/test_torch_trace_hf.py holds them against JAX.)
LEFT_OUT_OF = {
    "ops.lighting_pallas.render_gbuffers_fused": {"caps": "the fused cascade's levels"},
    "ops.path_vol.render_gbuffers_path": {"cap": "the round schedule", "rounds": "the round schedule"},
}
# Defaults of the port's own: a parameter JAX and the port share, bound to
# the same name, whose default differs, each with the port's default.
OWN_DEFAULTS = {
    # JAX writes its trace to a fixed /tmp path; the port's default (None)
    # is a directory under TMPDIR, so that two checkouts profiled with their
    # own TMPDIR do not write over each other's traces.
    "apps.profile.run": {"out_dir": None},
}


def _modules(package) -> dict:
    """Every module of ``package`` by its path in the package ("" the top)."""
    out = {"": package}
    for info in pkgutil.walk_packages(package.__path__, package.__name__ + "."):
        out[info.name[len(package.__name__) + 1:]] = importlib.import_module(info.name)
    return out


def _public(module) -> dict:
    """The public functions and classes ``module`` defines (jitted ones
    too), by name."""
    out = {}
    for name, obj in vars(module).items():
        inner = inspect.unwrap(obj) if callable(obj) else obj
        if not name.startswith("_") and (inspect.isfunction(inner) or inspect.isclass(inner)) \
                and getattr(inner, "__module__", None) == module.__name__:
            out[name] = obj
    return out


def _methods(cls) -> dict:
    return {name: obj for name, obj in vars(cls).items()
            if inspect.isfunction(obj) and not name.startswith("_")}


def _pairs() -> list:
    """(id, JAX callable, port callable or None) for every public name of
    the JAX package outside LEFT_OUT_NAMES; a class gives its constructor
    and each public method."""
    jax_mods, port_mods = _modules(raytrace_tpu), _modules(raytrace_tpu_torch)
    pairs = []
    for path, module in sorted(jax_mods.items()):
        homes = [port_mods[p] for p in PORT_MODULES.get(path, (path,)) if p in port_mods]
        for name, obj in sorted(_public(module).items()):
            key = f"{path}.{name}".lstrip(".")
            if key in LEFT_OUT_NAMES:
                continue
            if key in RENAMED:
                home, _, new = RENAMED[key].rpartition(".")
                found = getattr(port_mods[home], new)
            else:
                found = next((getattr(m, name) for m in homes if hasattr(m, name)), None)
            pairs.append((key, obj, found))
            if inspect.isclass(obj):
                for meth, fn in sorted(_methods(obj).items()):
                    pairs.append((f"{key}.{meth}", fn, getattr(found, meth, None)))
    return pairs


PAIRS = _pairs()


def _calls(sig: inspect.Signature):
    """Calls that ``sig`` accepts, as (args, kwargs) of sentinels: every
    count of positional arguments it takes (the other required ones by
    keyword), each optional parameter alone by keyword, every parameter by
    keyword, and an extra keyword where it takes ``**kwargs``."""
    params = list(sig.parameters.values())
    named = [p for p in params if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    positional = [p for p in named if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    required = [p for p in named if p.default is p.empty]
    token = {p.name: object() for p in named}
    calls = []
    for n in range(len(positional) + 1):
        if any(p.default is p.empty and p.kind == p.POSITIONAL_ONLY
               for p in positional[n:]):
            continue
        args = [token[p.name] for p in positional[:n]]
        kwargs = {p.name: token[p.name] for p in required if p not in positional[:n]}
        calls.append((args, kwargs))
    base = {p.name: token[p.name] for p in required}
    for p in named:
        if p.default is not p.empty and p.kind != p.POSITIONAL_ONLY:
            calls.append(([], {**base, p.name: token[p.name]}))
    calls.append(([], {p.name: token[p.name] for p in named if p.kind != p.POSITIONAL_ONLY}))
    if any(p.kind == p.VAR_KEYWORD for p in params):
        calls.append(([], {**base, "an_extra_keyword": object()}))
    return calls


def _same(a, b) -> bool:
    if a is b:
        return True
    try:
        return bool(a == b) and type(a) is type(b)
    except Exception:
        return False


@pytest.mark.parametrize("key,jax_fn,port_fn", PAIRS, ids=[p[0] for p in PAIRS])
def test_port_binds_every_jax_call(key, jax_fn, port_fn):
    """Every call JAX's signature accepts binds the shared parameters to
    the same names and defaults in the port, or raises ``TypeError`` there
    where it reaches a parameter left out by design."""
    assert port_fn is not None, f"{key} has no counterpart in the port"
    want, got = inspect.signature(jax_fn), inspect.signature(port_fn)
    # A knob's name the port keeps (``occupancy_pyramid``'s ``levels``) is
    # the port's parameter, held like any other.
    left_out = {n for n in LEFT_OUT_PARAMS if n not in got.parameters} \
        | set(LEFT_OUT_OF.get(key, ()))
    shared = [n for n in want.parameters if n not in left_out]
    for name in set(LEFT_OUT_OF.get(key, ())):
        assert name in want.parameters and name not in got.parameters, (key, name)
    own_defaults = OWN_DEFAULTS.get(key, {})
    for name, default in own_defaults.items():
        assert name in want.parameters and got.parameters[name].default == default, (key, name)
    for args, kwargs in _calls(want):
        jb = want.bind(*args, **kwargs)
        call = f"{key}({len(args)} positional, keywords {sorted(kwargs)})"
        reaches = any(n in left_out for n in jb.arguments)
        try:
            tb = got.bind(*args, **kwargs)
        except TypeError as e:
            assert reaches, f"{call} raises in the port: {e}"
            continue
        assert not reaches, f"{call} binds a parameter left out by design: {tb.arguments}"
        passed = set(jb.arguments)
        jb.apply_defaults()
        tb.apply_defaults()
        for name in shared:
            assert name in tb.arguments, f"{call}: the port has no {name!r}"
            if name in own_defaults and name not in passed:
                continue  # not passed: the port's own default, held above
            assert _same(tb.arguments[name], jb.arguments[name]), \
                f"{call}: {name!r} binds {tb.arguments[name]!r}, JAX {jb.arguments[name]!r}"
        for name in set(tb.arguments) - set(shared):
            # The port's own parameters take no value of a JAX call.
            kind = got.parameters[name].kind
            if kind == inspect.Parameter.VAR_KEYWORD:
                assert tb.arguments[name] == jb.arguments.get(name, {}), call
            else:
                assert _same(tb.arguments[name], got.parameters[name].default), \
                    f"{call}: the port's own {name!r} took a value"


def test_the_allow_lists_name_what_jax_has():
    """Each left-out name exists in JAX and not in the port; each renamed
    pair exists on both sides."""
    jax_mods, port_mods = _modules(raytrace_tpu), _modules(raytrace_tpu_torch)
    for key in LEFT_OUT_NAMES:
        path, _, name = key.rpartition(".")
        assert hasattr(jax_mods[path], name), key
        homes = PORT_MODULES.get(path, (path,))
        assert not any(hasattr(port_mods[p], name) for p in homes if p in port_mods), key
    for key, new in RENAMED.items():
        path, _, name = key.rpartition(".")
        home, _, port_name = new.rpartition(".")
        assert hasattr(jax_mods[path], name) and hasattr(port_mods[home], port_name), key
    assert set(OWN_DEFAULTS) <= {key for key, _, _ in PAIRS}
    assert len(PAIRS) > 100


def test_profile_traces_default_under_tmpdir(monkeypatch, tmp_path):
    """``apps.profile.run``'s traces go under the temporary directory
    (``TMPDIR``) when no ``out_dir`` is given, not to a path shared by every
    checkout on the machine."""
    import tempfile

    from raytrace_tpu_torch.apps import profile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert profile.default_out_dir() == tmp_path / "raytrace_tpu_trace"


def test_top_level_has_jax_names():
    """``constants``, ``MATERIALS``, ``Material`` and ``create_instance``
    at the top level, as in JAX; the materials are the port's own copies."""
    from raytrace_tpu_torch import constants, materials

    jax_names = {n for n in vars(raytrace_tpu) if not n.startswith("_")}
    assert jax_names <= set(vars(raytrace_tpu_torch))
    assert raytrace_tpu_torch.constants is constants
    assert raytrace_tpu_torch.MATERIALS is materials.MATERIALS
    assert raytrace_tpu_torch.Material is materials.Material
    assert len(raytrace_tpu_torch.MATERIALS) == len(raytrace_tpu.MATERIALS)


# --- The calls that changed shape, on the CPU ---------------------------------

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _view(cls, lr=(0, 0, 0), y=-100.0, facing=1.0):
    """The generated world's view that needs no slice move from lr 0: from
    y = -100 toward +y, or (``facing`` -1) toward -y."""
    pitch = -0.05
    return cls(origin=(8.0, y, 14.0), sun_angle=0.6, seed=3, lr=lr,
               forward=(0.0, facing * float(np.cos(pitch)), float(np.sin(pitch))),
               up=(0.0, -facing * 0.4 * float(np.sin(pitch)), 0.4 * float(np.cos(pitch))),
               right=(facing * 0.4, 0.0, 0.0))


def _edge_view(cls, lr):
    """A view from y = -60 toward the region's -y face, which lies 68
    voxels ahead at lr.y 0 and 52 at lr.y 16: about half its rays hit, and
    where the others leave the region (sky, or more terrain) follows lr.y
    on every tracer."""
    return _view(cls, lr, y=-60.0, facing=-1.0)


@pytest.fixture(scope="module")
def volumes(full_world_volume):
    """The generated 256^3 region around the origin: (JAX's fused volume,
    the port's)."""
    mats, mf = full_world_volume
    fused = fuse_volume(jnp.asarray(mats), jnp.asarray(mf))
    return fused, convert.volume_from_jax(fused, "cpu")


def _world(tracer, volumes):
    if tracer == "fused":
        return with_column_heights(build_hf_tables((0, 0, 0), device="cpu"), 0)
    if tracer == "hf":
        return build_hf_tables((0, 0, 0), device="cpu")
    volume = volumes[1]
    return volume if tracer == "volume" else (volume, build_vol_tables(volume))


@pytest.mark.parametrize("tracer", pipeline.TRACERS)
def test_render_frame_of_a_dict_equals_the_packed_frame(volumes, tracer):
    """``render_frame(world, bn, FrameUniforms.as_device_dict(), W, H,
    with_gbuffers=True, tracer=t)`` is ``render_frame_packed`` of the same
    uniforms bit for bit, frame and G-buffers; without ``with_gbuffers`` it
    returns the frame alone."""
    bn = torch.from_numpy(get_blue_noise_f32())
    u = _view(pipeline.FrameUniforms)
    world = _world(tracer, volumes)
    frame, gb = pipeline.render_frame(world, bn, u.as_device_dict("cpu"), SIZE, SIZE,
                                      with_gbuffers=True, tracer=tracer)
    want, gb_want = pipeline.render_frame_packed(world, bn, torch.from_numpy(u.packed()),
                                                 SIZE, SIZE, tracer=tracer)
    assert torch.equal(frame, want)
    assert gb.keys() == gb_want.keys()
    assert all(torch.equal(gb[k], gb_want[k]) for k in gb)
    if tracer == "fused":
        alone = pipeline.render_frame(world, bn, u.as_device_dict("cpu"), SIZE, SIZE,
                                      tracer=tracer)
        assert isinstance(alone, torch.Tensor) and torch.equal(alone, want)


def test_as_device_dict_is_jaxs_and_the_packed_form():
    """JAX's seven keys, dtypes and values, equal to the packed vector's."""
    u = _view(pipeline.FrameUniforms, lr=(16, 0, -32))
    got = u.as_device_dict("cpu")
    want = _view(jax_pipeline.FrameUniforms, lr=(16, 0, -32)).as_device_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
    unpacked = pipeline.unpack_uniforms(torch.from_numpy(u.packed()))
    assert all(torch.equal(got[k], unpacked[k]) for k in got)


LRS = {"lr_y0": (0, 0, 0), "lr_y16": (0, 16, 0)}


def _assert_like_jax(frame, gb, want, gb_want):
    """A frame within ``compare_images`` of JAX's, and its G-buffers within
    the bounds of ``tests/test_torch_lighting.py``, ``test_torch_path_vol.py``
    and ``test_torch_trace_dda.py`` (jitted): normal, albedo and lighting
    (1e-5) on at least 99.5% of pixels, depth within one quantum where the
    normals agree, fog within 1e-6, and some pixels hit."""
    stats = compare_images(frame.numpy(), np.asarray(want))
    print(stats)
    assert stats["ok"], stats
    got = {k: v.numpy() for k, v in gb.items()}
    gb_want = {k: np.asarray(v) for k, v in gb_want.items()}
    normal_ok = got["normal"] == gb_want["normal"]
    albedo_ok = (got["albedo"] == gb_want["albedo"]).all(-1)
    light_ok = np.isclose(got["lighting"], gb_want["lighting"], atol=1e-5, rtol=1e-5).all(-1)
    assert min(normal_ok.mean(), albedo_ok.mean(), light_ok.mean()) >= 0.995
    d = np.abs(got["depth"].astype(np.int64) - gb_want["depth"].astype(np.int64))
    assert d[normal_ok].max() <= 1
    np.testing.assert_allclose(got["fog"], gb_want["fog"], atol=1e-6)
    assert (got["depth"] != 0xFFFF).any()


@pytest.mark.parametrize("lr", list(LRS.values()), ids=list(LRS))
def test_volume_frame_matches_jax_render_frame(volumes, lr):
    """The exact DDA's frame and G-buffers of a uniforms dict against JAX's
    ``render_frame(..., with_gbuffers=True)`` (jitted) at ``_edge_view``,
    within ``_assert_like_jax``.  A dict whose ``lr.y`` is not 0 renders as
    JAX's does: every component of ``lr`` is read (a frame that dropped
    lr.y differs on 8-13% of its pixels here, on every tracer)."""
    fused, volume = volumes
    bn = get_blue_noise_f32()
    want, gb_want = jax_pipeline.render_frame(
        fused, jnp.asarray(bn), _edge_view(jax_pipeline.FrameUniforms, lr).as_device_dict(),
        SIZE, SIZE, with_gbuffers=True, tracer="volume")
    frame, gb = pipeline.render_frame(
        volume, torch.from_numpy(bn), _edge_view(pipeline.FrameUniforms, lr).as_device_dict("cpu"),
        SIZE, SIZE, with_gbuffers=True, tracer="volume")
    _assert_like_jax(frame, gb, want, gb_want)


@pytest.mark.parametrize("lr", list(LRS.values()), ids=list(LRS))
@pytest.mark.parametrize("tracer", ["fused", "hf", "volume_fast"])
def test_frame_matches_jax_render_frame(volumes, tracer, lr):
    """The other tracers as the exact DDA above: each side's world built by
    its own package for ``lr`` (the region tables at ``lr``, whose ``y``
    moves the heightfield's region; the occupancy tables of the generated
    volume), JAX's Pallas kernels in interpret mode.  So ``lr.y`` 16
    renders as JAX's does on every tracer."""
    fused, volume = volumes
    bn = get_blue_noise_f32()
    if tracer == "volume_fast":
        jax_world, world = (fused, jax_build_vol_tables(fused)), (volume, build_vol_tables(volume))
    else:
        jax_world = jax_build_hf_tables(jnp.asarray(lr, jnp.int32), seed=0)
        world = build_hf_tables(lr, seed=0, device="cpu")
    want, gb_want = jax_pipeline.render_frame(
        jax_world, jnp.asarray(bn), _edge_view(jax_pipeline.FrameUniforms, lr).as_device_dict(),
        SIZE, SIZE, with_gbuffers=True, tracer=tracer)
    frame, gb = pipeline.render_frame(
        world, torch.from_numpy(bn), _edge_view(pipeline.FrameUniforms, lr).as_device_dict("cpu"),
        SIZE, SIZE, with_gbuffers=True, tracer=tracer)
    _assert_like_jax(frame, gb, want, gb_want)


def test_pipeline_by_position_in_jax_order():
    """``Pipeline(width, height, seed, max_steps, source, storage, tracer,
    preloaded_volume, validate, bounces)``, as JAX's, with ``device``
    after them by keyword."""
    p = pipeline.Pipeline(16, 24, 7, 512, "device", None, "hf", None, False, 1, device="cpu")
    assert (p.width, p.height, p.seed, p.max_steps) == (16, 24, 7, 512)
    assert (p.streamer.source, p.streamer.storage, p.tracer) == ("device", None, "hf")
    assert (p.validate, p.bounces, p.device.type) == (False, 1, "cpu")
    assert p.streamer.seed == 7
    with pytest.raises(TypeError):
        pipeline.Pipeline(16, 24, 7, 512, "device", None, "hf", None, False, 1, "cpu")


def test_create_instance_ignores_the_game():
    """``create_instance(game, **pipeline_kwargs)`` as in JAX: the game is
    ignored and the keywords build the ``Pipeline``."""
    for game in (None, object()):
        p = raytrace_tpu_torch.create_instance(game, width=16, height=16, tracer="hf",
                                               device="cpu")
        assert isinstance(p, pipeline.Pipeline)
        assert (p.width, p.height, p.tracer, p.device.type) == (16, 16, "hf", "cpu")


def test_draw_frame_keeps_the_reprojection_fields():
    """After a frame, ``old_origin`` is its camera origin and
    ``old_transform`` the inverse of its (right, up, forward) columns, as
    JAX's ``draw_frame`` leaves them; ``teleport`` leaves them as they were,
    as JAX's does."""
    p = pipeline.Pipeline(width=16, height=16, tracer="fused", device="cpu")
    u = p.uniforms
    assert u.old_origin == (0.0, 0.0, 0.0) and u.old_transform == ((1, 0, 0), (0, 1, 0), (0, 0, 1))
    cam = Camera(origin=[8.0, -100.0, 14.0], pitch=-0.3, heading=0.4)
    p.draw_frame(cam, 0.6)
    assert u.old_origin == u.origin == tuple(cam.origin)
    want = jax_pipeline._invert3(tuple(zip(*(u.right, u.up, u.forward))))
    assert u.old_transform == want
    before = (u.old_origin, u.old_transform)
    p.teleport(Camera(origin=[300.0, 0.0, 14.0]))
    assert (u.old_origin, u.old_transform) == before


# Boxes no 64-aligned mode takes: unaligned origins and extents, negative
# origins, boxes below z = 0 and across the surface, one voxel.
BOXES = {
    "unaligned_100x77x45": ((-37, 21, -5), (100, 77, 45)),
    "negative_origin": ((-131, -67, -30), (33, 70, 80)),
    "across_the_surface": ((5, -9, 2), (31, 17, 20)),
    "one_voxel": ((-1, -1, -1), (1, 1, 1)),
    "one_voxel_above": ((13, 7, 90), (1, 1, 1)),
    "one_column": ((-300, 517, -3), (1, 1, 64)),
}


@pytest.mark.parametrize("case", list(BOXES))
def test_generate_box_without_the_minefield_takes_any_box(case):
    """``generate_box(origin, shape, seed, with_minefield=False,
    device="cpu")`` equals JAX's ``materials`` and ``solid`` word for word
    (JAX run op by op) and has no minefield, as JAX's; so does the plain
    version."""
    origin, shape = BOXES[case]
    seed = 3
    with jax.disable_jit():
        want = jax_gen.generate_box(origin, shape, seed=seed, with_minefield=False)
    got = generate.generate_box(origin, shape, seed, False, device="cpu")
    plain = generate.generate_box_plain(origin, shape, seed, with_minefield=False)
    assert set(got) == set(want) == {"materials", "solid"}
    np.testing.assert_array_equal(got["materials"].numpy().view(np.uint32),
                                  np.asarray(want["materials"]))
    np.testing.assert_array_equal(got["solid"].numpy(), np.asarray(want["solid"]))
    assert all(torch.equal(got[k], plain[k]) for k in got)
    solid = np.asarray(want["solid"])
    assert solid.all() if case == "one_voxel" else (
        not solid.any() if case == "one_voxel_above" else 0 < solid.mean() < 1)


def test_generate_box_with_the_minefield_stays_aligned():
    """The minefield's box must stay 64-aligned, as before; a box of an
    empty extent is refused in both modes."""
    with pytest.raises(ValueError, match="64-aligned"):
        generate.generate_box((32, 0, 0), (64, 64, 64), device="cpu")
    for with_minefield in (True, False):
        with pytest.raises(ValueError, match="extents >= 1"):
            generate.generate_box((0, 0, 0), (0, 64, 64), 0, with_minefield, device="cpu")
    box = generate.generate_box((0, 0, -64), (64, 64, 64), device="cpu")
    assert set(box) == {"materials", "solid", "minefield"}


# Each entry point that runs on the card unless given a device.
DEFAULT_DEVICE_CALLS = {
    "generate_box": lambda: generate.generate_box((0, 0, 0), (64, 64, 64)),
    "generate_box_bare": lambda: generate.generate_box((1, 2, 3), (4, 5, 6),
                                                       with_minefield=False),
    "generate_chunk": lambda: generate.generate_chunk((0, 0, 0)),
    "build_hf_tables": lambda: build_hf_tables((0, 0, 0)),
    "heightmap_grid": lambda: heightmap.heightmap_grid(0, 0),
    "generate_heightmap": lambda: heightmap.generate_heightmap((0, 0)),
    "mountain_noise2_grid": lambda: noise.mountain_noise2_grid(0, 0, (4, 4)),
    "as_device_dict": lambda: pipeline.FrameUniforms().as_device_dict(),
    "create_instance": lambda: raytrace_tpu_torch.create_instance(width=16, height=16),
}


@pytest.mark.parametrize("name", list(DEFAULT_DEVICE_CALLS))
def test_entry_points_default_to_the_card(name):
    """With no device, each entry point runs on the card, as JAX's run on
    its default device: without a GPU it raises instead of building on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present; the no-GPU refusal cannot be shown")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        DEFAULT_DEVICE_CALLS[name]()


def test_a_tensors_device_decides():
    """A tensor argument's device still decides where the call runs: the
    region tables of a CPU ``lr`` tensor, or of the packed uniforms, are
    built on the CPU without a device, equal to the host ``lr``'s."""
    want = build_hf_tables((16, 0, -32), device="cpu")
    u = pipeline.FrameUniforms(lr=(16, 0, -32))
    for lr in (torch.tensor([16, 0, -32], dtype=torch.int32), torch.from_numpy(u.packed())):
        got = build_hf_tables(lr)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert heightmap.heightmap_grid(0, 0, device="cpu").shape == (64, 64)
