"""The port's apps against the JAX package's, on the CPU at 24²-32²:
capture (manifest and frames), PNG files, the flythrough loop with its
edit keys and terminal input, generate_world, the benchmark's record and
its exhausted-pixel count, and that every app refuses to run without a GPU
unless asked for the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytrace_tpu.apps import benchmark as jax_benchmark
from raytrace_tpu.apps import capture as jax_capture
from raytrace_tpu.apps import generate_world as jax_generate_world
from raytrace_tpu.render import pipeline as jax_pipeline
from raytrace_tpu.render import streaming as jax_streaming
from raytrace_tpu.testing import golden as jax_golden
from raytrace_tpu.world import storage as jax_storage
from raytrace_tpu_torch.apps import (
    benchmark,
    capture,
    debug_view,
    flythrough,
    generate_world,
    stage_times,
)
from raytrace_tpu_torch.engine.controls import ControlSet
from raytrace_tpu_torch.render import streaming
from raytrace_tpu_torch.render.pipeline import Pipeline
from raytrace_tpu_torch.testing.golden import compare_images, read_png, save_png
from raytrace_tpu_torch.world.storage import ChunkStorage

ROOT = Path(__file__).parent.parent


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: the suite runs several workers
    on one machine's cores, where eight threads a worker thrash."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fused_words(full_world_volume):
    """The fixture region as fused uint32 words (world [-128, 128)^3)."""
    mats, mf = full_world_volume
    return (mats | (mf.astype(np.uint32) << 24)).reshape(-1)


def test_capture_matches_jax(fused_words, monkeypatch, tmp_path):
    """capture.run of 2 views with the exact-DDA pipeline of each package at
    32²: the same manifest, and frames within compare_images.  Teleport's
    region generation is held to JAX elsewhere
    (test_streamer_volume_matches_jax); here both packages teleport onto
    the fixture's region, so that no region is generated."""
    words = torch.from_numpy(fused_words.view(np.int32))
    monkeypatch.setattr(jax_streaming, "_generate_region",
                        lambda o, n, seed: jnp.asarray(fused_words))
    monkeypatch.setattr(streaming, "_generate_region",
                        lambda volume, o, n, seed: volume.copy_(words))
    kw = dict(width=32, height=32, max_steps=128, tracer="volume",
              preloaded_volume=fused_words)
    theirs = jax_pipeline.Pipeline(**kw)
    ours = Pipeline(device="cpu", **kw)
    jax_capture.run(tmp_path / "jax", limit=2, pipeline=theirs)
    n, dt = capture.run(tmp_path / "port", limit=2, pipeline=ours)
    assert n == 1 and dt > 0
    manifests = [json.loads((tmp_path / d / "manifest.json").read_text())
                 for d in ("port", "jax")]
    assert manifests[0] == manifests[1]
    assert manifests[0][1]["file"] == "view_00001.dat"
    assert manifests[0][1]["shape"] == [32, 32, 3] and manifests[0][1]["dtype"] == "uint8"
    assert ours.uniforms.lr == theirs.uniforms.lr == (-32, 0, 96)
    for entry in manifests[0]:
        got, want = (np.fromfile(tmp_path / d / entry["file"], np.uint8).reshape(32, 32, 3)
                     for d in ("port", "jax"))
        stats = compare_images(got / 255.0, want / 255.0)
        print(stats)
        assert stats["ok"], stats
        assert got.std() > 10  # terrain, not only sky


def _cpu_pipeline(**kw):
    return Pipeline(width=24, height=24, device="cpu", **kw)


def test_capture_png_decodes_to_dat(tmp_path):
    """The same views as .dat and as png-fast PNGs (two fresh pipelines,
    so the same noise seeds): each PNG holds its view's bytes, read by the
    port's reader and by Pillow."""
    from PIL import Image

    capture.run(tmp_path / "dat", limit=2, pipeline=_cpu_pipeline())
    capture.run(tmp_path / "png", limit=2, pipeline=_cpu_pipeline(), fmt="png-fast")
    manifest = json.loads((tmp_path / "png" / "manifest.json").read_text())
    assert [e["file"] for e in manifest] == ["view_00000.png", "view_00001.png"]
    assert "shape" not in manifest[0]
    for i in range(2):
        dat = np.fromfile(tmp_path / "dat" / f"view_{i:05d}.dat", np.uint8).reshape(24, 24, 3)
        png = tmp_path / "png" / f"view_{i:05d}.png"
        np.testing.assert_array_equal(read_png(png), dat)
        np.testing.assert_array_equal(np.asarray(Image.open(png)), dat)
    with pytest.raises(ValueError, match="unknown capture format"):
        capture.run(tmp_path / "bad", limit=1, pipeline=object(), fmt="jpeg")


@pytest.mark.parametrize("level", [1, 6])
@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_save_png_decodes_like_jax(tmp_path, level, kind):
    from PIL import Image

    rng = np.random.default_rng(level)
    img = rng.random((13, 21, 3)).astype(np.float32) * 1.2 - 0.1  # clipped ends
    if kind == "uint8":
        img = np.clip(img * 255, 0, 255).astype(np.uint8)
    save_png(tmp_path / "port.png", img, compress_level=level)
    jax_golden.save_png(tmp_path / "jax.png", img, compress_level=level)
    got = np.asarray(Image.open(tmp_path / "port.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert got.dtype == np.uint8 and got.shape == (13, 21, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_png(tmp_path / "port.png"), want)
    (tmp_path / "not.png").write_bytes(b"RTL4" * 8)
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "not.png")


@pytest.fixture()
def volume_pipelines(fused_words, monkeypatch):
    """flythrough.Pipeline made to build a cheap CPU pipeline on the
    fixture's region: the exact DDA at max_steps 128, as
    tests/test_apps.py's cheap pipeline."""
    made = []

    def make(**kw):
        made.append(_cpu_pipeline(max_steps=128, tracer="volume",
                                  preloaded_volume=fused_words))
        return made[-1]

    monkeypatch.setattr(flythrough, "Pipeline", make)
    return made


def test_flythrough_run_scripted(volume_pipelines):
    frame, avg, mx = flythrough.run(
        ["0", "0", "60", "1.5708", "-0.3", "0.6"], frames=3, width=24, height=24,
        script=[(0, "press", "w"), (2, "release", "w")], quiet=True)
    assert frame.shape == (24, 24, 3) and np.isfinite(frame).all()
    assert 0.0 < avg <= mx
    assert volume_pipelines[0].uniforms.origin[1] > 0.0  # w moved the camera


def test_flythrough_edit_key_places_block(volume_pipelines):
    """The 'b' key writes a box ahead of the camera through
    Pipeline.edit_box and the next frame shows it; two runs without it are
    bit-equal (a static camera and fresh pipelines)."""
    cam = ["0", "0", "60", "1.5708", "-0.3", "0.6"]
    common = dict(frames=2, width=24, height=24, quiet=True)
    base, *_ = flythrough.run(cam, script=[], **common)
    again, *_ = flythrough.run(cam, script=[], **common)
    np.testing.assert_array_equal(base, again)
    edited, *_ = flythrough.run(cam, script=[(1, "press", "b")], **common)
    assert not np.array_equal(base, edited)


def test_flythrough_edit_hint_on_heightfield_tracers(monkeypatch, capsys):
    made = []
    monkeypatch.setattr(flythrough, "Pipeline",
                        lambda **kw: made.append(_cpu_pipeline(tracer="hf", max_steps=64))
                        or made[-1])
    flythrough.run(frames=2, width=24, height=24, script=[(1, "press", "x")])
    out = capsys.readouterr().out
    assert "tracer='hf' cannot display edits" in out


def test_terminal_input_hold_release(monkeypatch):
    """TerminalInput.pump: a received key is held for hold_frames frames,
    then released; ESC quits (tests/test_apps.py's case on the port)."""
    import select as select_mod

    ti = object.__new__(flythrough.TerminalInput)  # skip the tty-mode __init__
    ti._hold = {k: 0 for k in flythrough.TerminalInput.KEYS}
    ti._hold_frames = 2
    ti.quit = False
    controls = ControlSet()
    controls.add_control("forward", "w")
    pending = ["w"]

    class FakeStdin:
        @staticmethod
        def read(n):
            return pending.pop(0)

    monkeypatch.setattr(select_mod, "select", lambda r, w, x, t: ([1] if pending else [], [], []))
    monkeypatch.setattr(sys, "stdin", FakeStdin)
    ti.pump(controls)
    assert controls.is_held("forward")
    controls.tick()
    ti.pump(controls)
    assert controls.is_held("forward")
    controls.tick()
    ti.pump(controls)
    assert not controls.is_held("forward")
    pending.append("\x1b")
    ti.pump(controls)
    assert ti.quit


def test_generate_world_matches_the_fixture(full_world_volume, tmp_path):
    """The 8 chunks of radius 1, generated an x-row at a time, decode (in
    both packages) to the fixture's voxels, and each file is byte for byte
    the one JAX's ``generate_world`` writes."""
    mats, mf = full_world_volume
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    tracker = generate_world.run(radius=1, storage_dir=port, device="cpu")
    jax_generate_world.run(radius=1, storage_dir=jax_dir)
    names = sorted(p.name for p in port.iterdir())
    assert tracker.done == 8 and len(names) == 8
    assert names == sorted(p.name for p in jax_dir.iterdir())
    for name in names:
        assert (port / name).read_bytes() == (jax_dir / name).read_bytes()
    theirs = jax_storage.ChunkStorage(port)
    ours = ChunkStorage(port, device="cpu")
    for coord in [(cx, cy, cz) for cz in (-1, 0) for cy in (-1, 0) for cx in (-1, 0)]:
        sl = tuple(slice((c + 2) * 64, (c + 3) * 64) for c in reversed(coord))
        assert ours.path_for(coord).read_bytes()[:4] == b"RTL4"
        got_m, got_f = ours.borrow_packed_chunk_data(coord)
        np.testing.assert_array_equal(got_m.view(np.uint32), mats[sl])
        np.testing.assert_array_equal(got_f, mf[sl])
        np.testing.assert_array_equal(theirs.borrow_packed_chunk_data(coord)[0], mats[sl])


def test_benchmark_emit_matches_jax(capsys):
    for args in [("1_single_chunk_primary", 12.3456, "Mrays/s", {"exhausted_px": 0}),
                 ("3_flythrough_streaming", 7.0, "ms/frame", None)]:
        ours = benchmark._emit(*args)
        ours_line = capsys.readouterr().out
        theirs = jax_benchmark._emit(*args)
        assert ours == theirs and ours_line == capsys.readouterr().out
        assert json.loads(ours_line) == ours


def test_benchmark_counts_exhausted_pixels_at_32():
    """exhausted_px counts the primaries cut by their budget (JAX's depth ==
    65024): many at max_steps 6, as the pipeline's validate counts them;
    none at the apps' budget."""
    cut = Pipeline(width=32, height=32, device="cpu", tracer="hf", max_steps=6)
    from raytrace_tpu_torch.render.camera import Camera

    cam = Camera(origin=[-30.0, -100.0, 60.0], pitch=-0.3)
    cut.draw_frame(cam, 0.6)
    depth = cut.gbuffers["depth"]
    count = benchmark.exhausted_px(depth)
    assert count.dtype == torch.int64 and count.dim() == 0
    want = int((depth.numpy() == 65024).sum())
    assert int(count) == want == cut._validate_frame(
        cut.draw_frame(cam, 0.6), cut.gbuffers)["exhausted"] > 0
    full = Pipeline(width=32, height=32, device="cpu")
    full.draw_frame(cam, 0.6)
    assert int(benchmark.exhausted_px(full.gbuffers["depth"])) == 0
    assert set(benchmark.CONFIGS) == {"1", "2", "3", "4", "5"}


_NEEDS_GPU = {
    "storage": lambda tmp: ChunkStorage(tmp),
    "generate_world": lambda tmp: generate_world.run(radius=1, storage_dir=tmp),
    "capture": lambda tmp: capture.run(tmp, 16, 16, limit=1),
    "flythrough": lambda tmp: flythrough.run(frames=1, width=16, height=16, quiet=True),
    "debug_view": lambda tmp: debug_view.run(tmp),
    "stage_times": lambda tmp: stage_times.run(frames=1, width=16, height=16),
    **{f"benchmark_{k}": (lambda fn: lambda tmp: fn())(fn)
       for k, fn in benchmark.CONFIGS.items()},
}


@pytest.mark.parametrize("app", list(_NEEDS_GPU))
def test_apps_need_a_gpu(app, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present; the no-GPU refusal cannot be shown")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        _NEEDS_GPU[app](tmp_path)


def test_apps_and_cache_run_without_jax(tmp_path):
    """Every app imports, and the chunk cache generates, stores and reads a
    chunk on the CPU, with no jax and no raytrace_tpu module loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import numpy as np\n"
        "import raytrace_tpu_torch.apps as apps\n"
        "for m in pkgutil.iter_modules(apps.__path__, 'raytrace_tpu_torch.apps.'):\n"
        "    importlib.import_module(m.name)\n"
        "from raytrace_tpu_torch import native\n"
        "from raytrace_tpu_torch.world.storage import ChunkStorage\n"
        f"s = ChunkStorage({str(tmp_path)!r}, device='cpu')\n"
        "m, f = s.borrow_packed_chunk_data((0, 0, 0))\n"
        "assert native.lz4_available() and s.path_for((0, 0, 0)).read_bytes()[:4] == b'RTL4'\n"
        "m2, f2 = s.borrow_packed_chunk_data((0, 0, 0))\n"
        "assert np.array_equal(m, m2) and np.array_equal(f, f2) and m.any()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "ref = [m for m in sys.modules if m.split('.')[0] == 'raytrace_tpu']\n"
        "assert not ref, sorted(ref)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
