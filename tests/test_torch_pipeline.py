"""The port's whole frame and its pipeline glue, on the CPU.

The 64² frame at the canonical view, from the port's own region tables,
must match the committed golden and the live JAX frame; the streaming
control must walk the same region positions as the JAX streamer; and the
package must render without importing JAX.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytrace_tpu.ops.denoise_pallas import denoise_finalize_pallas
from raytrace_tpu.ops.trace_jax import fuse_volume
from raytrace_tpu.ops.lighting_pallas import render_gbuffers_fused
from raytrace_tpu.ops.trace_pallas import build_hf_tables as jax_build_hf_tables
from raytrace_tpu.render import pipeline as jax_pipeline
from raytrace_tpu.render.streaming import TerrainStreamer as JaxStreamer
from raytrace_tpu.utils.blue_noise import get_blue_noise_f32
from raytrace_tpu_torch import convert
from raytrace_tpu_torch.ops.hf_tables import build_hf_tables
from raytrace_tpu_torch.ops.vol_tables import build_vol_tables
from raytrace_tpu_torch.render import pipeline
from raytrace_tpu_torch.render.camera import Camera
from raytrace_tpu_torch.render.streaming import TerrainStreamer
from raytrace_tpu_torch.testing.golden import compare_images

ROOT = Path(__file__).parent.parent


def _canonical(cls):
    pitch = -0.3
    return cls(
        origin=(-30.0, -100.0, 60.0),
        sun_angle=0.6,
        forward=(0.0, float(np.cos(pitch)), float(np.sin(pitch))),
        up=(0.0, -0.4 * float(np.sin(pitch)), 0.4 * float(np.cos(pitch))),
        right=(0.4, 0.0, 0.0),
    )


@pytest.fixture(scope="module")
def port_frame():
    u = _canonical(pipeline.FrameUniforms)
    frame, gb = pipeline.render_frame_packed(
        build_hf_tables((0, 0, 0), seed=0, device="cpu"),
        torch.from_numpy(get_blue_noise_f32()), torch.from_numpy(u.packed()),
        64, 64, tracer="fused",
    )
    return frame.numpy(), gb


def test_frame_matches_committed_golden(port_frame):
    frame, gb = port_frame
    want = np.load(ROOT / "tests" / "goldens" / "terrain_frame_64.npz")["frame"]
    stats = compare_images(frame, want)
    print(stats)
    assert stats["ok"], stats
    assert int((gb["depth"] == 65024).sum()) == 0


def test_frame_matches_live_jax_frame(port_frame):
    frame, _ = port_frame
    bn = jnp.asarray(get_blue_noise_f32())
    u = _canonical(jax_pipeline.FrameUniforms).as_device_dict()
    tables = jax_build_hf_tables(jnp.zeros(3, jnp.int32), seed=0)
    gb = render_gbuffers_fused(tables, bn, u, 64, 64, max_steps=2048, seed=0,
                               interpret=True)
    want = np.asarray(denoise_finalize_pallas(gb, bn, interpret=True))
    stats = compare_images(frame, want)
    print(stats)
    assert stats["ok"], stats


def test_unpack_uniforms_reads_the_packed_vector():
    """unpack_uniforms gives the march the fields FrameUniforms packs."""
    u = _canonical(pipeline.FrameUniforms)
    u.seed, u.lr = 37, (16, 0, -32)
    got = pipeline.unpack_uniforms(torch.from_numpy(u.packed()))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    for name in ("origin", "forward", "up", "right", "sun_angle", "lr"):
        torch.testing.assert_close(got[name], f32(getattr(u, name)), rtol=0, atol=0)
    assert got["seed"].dtype == torch.int32 and int(got["seed"]) == 37
    u.lr = (16, 8, -32)
    with pytest.raises(ValueError, match="lr.y == 0"):
        u.packed()


def test_streamer_positions_match_jax():
    """request_move_towards walks the same region positions (the JAX
    streamer's request methods only: no volume is generated)."""
    ours, theirs = TerrainStreamer(device="cpu"), JaxStreamer(seed=0)
    targets = [(300, 0, -200)] * 30 + [(-500, 40, 90)] * 40 + [(0, 0, 0)] * 40
    for target in targets:
        ours.request_move_towards(target)
        theirs.request_move_towards(target)
        pos = lambda s: (s.cpu_position.origin, s.cpu_position.num_loaded_slices)
        assert pos(ours) == pos(theirs)
        assert [(r.origin, r.num_slices, r.axis) for r in ours.request_queue] == \
            [(r.origin, r.num_slices, r.axis) for r in theirs.request_queue]
    while ours.setup_next_request():
        pass
    assert ours.get_render_offset() == theirs.cpu_position.render_offset()


def test_streamer_defaults_to_the_card():
    """TerrainStreamer() places its volume on the card, as Pipeline does,
    and refuses to run without one rather than quietly on the CPU."""
    if torch.cuda.is_available():
        assert TerrainStreamer().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        TerrainStreamer()
    assert TerrainStreamer(device="cpu").device.type == "cpu"


def test_draw_frame_streams_and_advances_seed():
    p = pipeline.Pipeline(width=16, height=16, device="cpu")
    cam = Camera(origin=[40.0, 0.0, 60.0], heading=1.5708, pitch=-0.3)
    p.draw_frame(cam, 0.6)
    assert p.streamer.get_render_offset() == (16, 0, 0)
    frame = p.draw_frame(cam, 0.6)
    assert p.streamer.get_render_offset() == (32, 0, 0)
    assert p._tables_lr == (32, 0, 0)
    assert frame.shape == (16, 16, 3) and torch.isfinite(frame).all()
    assert p.uniforms.seed == 2
    p.uniforms.seed = 512 * 512 * 4 - 1
    p.draw_frame(cam, 0.0)
    assert p.uniforms.seed == 0


def test_pipeline_refuses_what_it_cannot_run():
    """An unknown tracer and a pipeline on the card without a GPU are
    refused.  A preloaded volume with a heightfield tracer is not, as in
    JAX: the streamer holds the volume JAX's holds, and the frame is the one
    rendered without it, bit for bit."""
    assert pipeline.TRACERS == ("fused", "hf", "volume", "volume_fast")
    with pytest.raises(ValueError, match="unknown tracer"):
        pipeline.Pipeline(tracer="raster", device="cpu")
    words = np.arange(256 ** 3, dtype=np.uint32) * np.uint32(2654435761)
    jax_held = np.asarray(jax_pipeline.Pipeline(
        width=16, height=16, tracer="fused", preloaded_volume=words).streamer.volume)
    cam = Camera(origin=[8.0, -100.0, 14.0], pitch=-0.3)  # no slice to stream
    for tracer in ("fused", "hf"):
        held = pipeline.Pipeline(width=16, height=16, tracer=tracer, device="cpu",
                                 preloaded_volume=torch.from_numpy(words.view(np.int32)))
        bare = pipeline.Pipeline(width=16, height=16, tracer=tracer, device="cpu")
        assert bare.streamer.volume is None
        np.testing.assert_array_equal(held.streamer.volume.numpy().view(np.uint32), jax_held)
        for sun in (0.6, 0.7):
            assert torch.equal(held.draw_frame(cam, sun), bare.draw_frame(cam, sun))
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present; the no-GPU refusal cannot be shown")
    for tracer in pipeline.TRACERS:
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            pipeline.Pipeline(width=16, height=16, tracer=tracer)


@pytest.fixture(scope="module")
def world_fused(full_world_volume):
    """The generated 256^3 region around the origin as a JAX fused volume."""
    mats, mf = full_world_volume
    return fuse_volume(jnp.asarray(mats), jnp.asarray(mf))


# A view of the generated world that needs no slice move from lr = 0.
_VOL_CAM = dict(origin=[8.0, -100.0, 14.0], pitch=-0.05)


def test_volume_fast_frame_matches_jax(world_fused):
    """One 32² volume_fast frame of the same preloaded volume through both
    pipelines' draw_frame."""
    ours = pipeline.Pipeline(width=32, height=32, device="cpu",
                             preloaded_volume=np.asarray(world_fused))
    theirs = jax_pipeline.Pipeline(width=32, height=32, preloaded_volume=world_fused)
    assert ours.tracer == theirs.tracer == "volume_fast"
    frame = ours.draw_frame(Camera(**_VOL_CAM), 0.6)
    want = np.asarray(theirs.draw_frame(Camera(**_VOL_CAM), 0.6))
    assert ours.streamer.get_render_offset() == (0, 0, 0)
    stats = compare_images(frame.numpy(), want)
    print(stats)
    assert stats["ok"], stats
    depth = ours.gbuffers["depth"].to(torch.int32)
    assert int((depth == 65024).sum()) == 0
    assert (depth == 0xFFFF).any() and (depth != 0xFFFF).any()


def test_preloaded_volume_is_copied_and_selects_volume_fast(world_fused):
    vol = convert.volume_from_jax(world_fused, "cpu")
    p = pipeline.Pipeline(width=16, height=16, device="cpu", preloaded_volume=vol)
    assert p.tracer == "volume_fast"
    assert torch.equal(p.streamer.volume, vol)
    assert p.streamer.volume.data_ptr() != vol.data_ptr()


def test_edit_box_changes_the_frame(world_fused):
    p = pipeline.Pipeline(width=16, height=16, device="cpu",
                          preloaded_volume=np.asarray(world_fused))
    cam = Camera(**_VOL_CAM)
    p.draw_frame(cam, 0.6)
    before = p.gbuffers["depth"].clone()
    # A rock wall across the view, 20 voxels in front of the camera.
    p.edit_box((-40, -80, 0), (80, 4, 40), 5)
    p.draw_frame(cam, 0.6)
    after = p.gbuffers["depth"]
    assert torch.equal(p.vol_tables()["detail"],
                       build_vol_tables(p.streamer.volume)["detail"])
    near = after.to(torch.int32) < before.to(torch.int32)
    assert near.float().mean() > 0.5
    with pytest.raises(ValueError, match="cannot display volume edits"):
        pipeline.Pipeline(width=16, height=16, device="cpu").edit_box(
            (0, 0, 0), (1, 1, 1), 2)


def test_volume_tables_follow_streamed_slabs(world_fused):
    """Slice moves update the occupancy tables incrementally; the result
    equals a rebuild of the streamed volume."""
    p = pipeline.Pipeline(width=8, height=8, device="cpu",
                          preloaded_volume=np.asarray(world_fused))
    cam = Camera(origin=[8.0, -100.0, 14.0], pitch=-0.05)
    p.draw_frame(cam, 0.6)
    for dx, dz in ((40, 0), (40, 0), (40, 40)):
        cam.origin = [8.0 + dx, -100.0, 14.0 + dz]
        p.draw_frame(cam, 0.6)
    assert p.streamer.get_render_offset() == (32, 0, 16)
    got, want = p._vol_tables, build_vol_tables(p.streamer.volume)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_profile_app_needs_a_gpu():
    from raytrace_tpu_torch.apps import profile

    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present; the no-GPU refusal cannot be shown")
    for tracer in pipeline.TRACERS + (profile.STAGED,):
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            profile.run(frames=2, width=16, height=16, tracer=tracer)


def test_package_renders_without_jax():
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import raytrace_tpu_torch as rt\n"
        "for m in pkgutil.walk_packages(rt.__path__, 'raytrace_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert {'raytrace_tpu_torch.parallel.tiles', 'raytrace_tpu_torch.testing.ranks',\n"
        "        'raytrace_tpu_torch.testing.reference_tracer',\n"
        "        'raytrace_tpu_torch.testing.shading_np'} <= set(sys.modules)\n"
        "from raytrace_tpu_torch.render.camera import Camera\n"
        "cam = Camera(origin=[-30.0, -100.0, 60.0], pitch=-0.3)\n"
        "from raytrace_tpu_torch.render.pipeline import TRACERS\n"
        "assert len(TRACERS) == 4\n"
        "for tracer in TRACERS:\n"
        "    p = rt.create_instance(width=16, height=16, device='cpu', tracer=tracer)\n"
        "    f = p.draw_frame(cam, 0.6)\n"
        "    assert f.shape == (16, 16, 3) and bool(torch.isfinite(f).all()), tracer\n"
        "    if tracer in ('volume', 'volume_fast'):\n"
        "        p.edit_box((-40, -90, 40), (8, 8, 8), 3)\n"
        "        assert bool(torch.isfinite(p.draw_frame(cam, 0.6)).all()), tracer\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "ref = [m for m in sys.modules if m.split('.')[0] == 'raytrace_tpu']\n"
        "assert not ref, sorted(ref)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _imported_modules(path: Path) -> set:
    import ast

    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke.py, read without running it, imports no JAX and nothing of
    the JAX package, and checks for the port's own files."""
    top = {name.split(".")[0] for name in _imported_modules(ROOT / "chip_smoke.py")}
    assert "raytrace_tpu_torch" in top and "torch" in top
    assert not top & {"jax", "jaxlib", "raytrace_tpu"}, top
    assert '"raytrace_tpu" /' not in (ROOT / "chip_smoke.py").read_text()


def test_port_sources_import_nothing_of_jax():
    """Every module of the port, read without running it (the tile split,
    the reference tracer and its NumPy shading among them)."""
    paths = sorted((ROOT / "raytrace_tpu_torch").rglob("*.py"))
    for path in paths:
        top = {name.split(".")[0] for name in _imported_modules(path)}
        assert not top & {"jax", "jaxlib", "raytrace_tpu"}, (path, top)
    names = {p.relative_to(ROOT / "raytrace_tpu_torch").as_posix() for p in paths}
    assert {"parallel/tiles.py", "testing/ranks.py", "testing/reference_tracer.py",
            "testing/shading_np.py", "ops/trace_dda.py"} <= names


def test_validate_reports_each_frame(capsys):
    """validate=True checks every frame: a budget too small to reach the
    terrain leaves exhausted (pink) pixels, which it reports and counts."""
    cam = Camera(origin=[-30.0, -100.0, 60.0], pitch=-0.3)
    p = pipeline.Pipeline(width=16, height=16, device="cpu", tracer="hf",
                          max_steps=6, validate=True)
    p.draw_frame(cam, 0.6)
    counts = p._validate_frame(p.draw_frame(cam, 0.6), p.gbuffers)
    out = capsys.readouterr().out
    assert counts["exhausted"] > 0 and counts["nonfinite"] == 0
    assert f"{counts['exhausted']} rays hit the 6-step limiter" in out
    quiet = pipeline.Pipeline(width=16, height=16, device="cpu", tracer="hf")
    assert not quiet.validate
    quiet.draw_frame(cam, 0.6)
    assert capsys.readouterr().out == ""


def test_validate_defaults_to_the_environment(monkeypatch):
    """validate=None reads RAYTRACE_TPU_VALIDATE, as the JAX pipeline does;
    an explicit value wins."""
    make = lambda **kw: pipeline.Pipeline(width=8, height=8, device="cpu", **kw)
    monkeypatch.setenv("RAYTRACE_TPU_VALIDATE", "1")
    assert make().validate is True
    assert make(validate=False).validate is False
    monkeypatch.setenv("RAYTRACE_TPU_VALIDATE", "0")
    assert make().validate is False
    monkeypatch.delenv("RAYTRACE_TPU_VALIDATE")
    assert make().validate is False
    assert make(validate=True).validate is True


def test_fused_frame_takes_bare_tables(monkeypatch):
    """render_gbuffers_fused takes build_hf_tables' dict as JAX's does: it
    builds the column table K1 reads for the call, and the frame equals the
    frame from tables that carry it."""
    from raytrace_tpu_torch.ops import lighting
    from raytrace_tpu_torch.ops.hf_tables import column_heights, with_column_heights

    bare = build_hf_tables((0, 0, 0), seed=0, device="cpu")
    u = pipeline.unpack_uniforms(torch.from_numpy(_canonical(pipeline.FrameUniforms).packed()))
    bn = torch.from_numpy(get_blue_noise_f32())
    seen = []
    march = lighting.march_paths

    def spy(*args, **kwargs):
        seen.append(args[5])
        return march(*args, **kwargs)

    monkeypatch.setattr(lighting, "march_paths", spy)
    got = lighting.render_gbuffers_fused(bare, bn, u, 32, 32)
    want = lighting.render_gbuffers_fused(with_column_heights(bare, 0), bn, u, 32, 32)
    assert "hcol" not in bare
    assert torch.equal(seen[0]["hcol"], column_heights(bare, 0))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_pipeline_tables_carry_the_column_table():
    """The pipeline builds the column table K1 reads with the region's
    tables, for the region it renders."""
    from raytrace_tpu_torch.ops.hf_tables import column_heights

    p = pipeline.Pipeline(width=16, height=16, device="cpu")
    p.uniforms.lr = (32, 0, -16)
    tables = p.tables()
    want = build_hf_tables((32, 0, -16), seed=0, device="cpu")
    assert torch.equal(tables["r0"], want["r0"])
    assert torch.equal(tables["hcol"], column_heights(want, 0))


def test_hf_pipeline_tables_have_no_column_table():
    """The staged tracer (K4) evaluates its heights: its pipeline builds
    the region's tables without the column table, equal to a fresh build."""
    p = pipeline.Pipeline(width=16, height=16, device="cpu", tracer="hf")
    p.uniforms.lr = (32, 0, -16)
    tables = p.tables()
    want = build_hf_tables((32, 0, -16), seed=0, device="cpu")
    assert set(tables) == set(want)
    assert all(torch.equal(tables[k], want[k]) for k in want)
