"""The frame program (``render/frame_graph.py``) on the CPU.

On the card ``Pipeline.draw_frame`` replays one CUDA graph a frame for
every tracer ("fused", "hf", "volume" and "volume_fast"); on a CPU pipeline the same frame program
runs its function eagerly over the same static buffers, so the buffer
handling (what each world event copies in, what the pipeline keeps) is held
here against a twin pipeline that renders every frame through
``render_frame_packed`` on its own world (``apps.profile.eager_frame``), bit for
bit.  The capture itself, and the launch counters' replay, need the card
(``chip_smoke.py``'s ``graph_frames_*`` phases).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytrace_tpu.render import pipeline as jax_pipeline
from raytrace_tpu.render.camera import Camera as JaxCamera
from raytrace_tpu_torch.apps.profile import eager_frame
from raytrace_tpu_torch.constants import MAX_TRACE_STEPS
from raytrace_tpu_torch.ops import hf_tables
from raytrace_tpu_torch.ops.hf_tables import build_hf_tables, with_column_heights
from raytrace_tpu_torch.render import frame_graph
from raytrace_tpu_torch.render.camera import Camera
from raytrace_tpu_torch.render.pipeline import TRACERS, VOLUME_TRACERS, Pipeline, render_frame_packed
from raytrace_tpu_torch.testing.golden import compare_images
from raytrace_tpu_torch.utils.blue_noise import get_blue_noise_f32

SIZE = 32


def _camera(cls=Camera):
    return cls(origin=[-30.0, -100.0, 60.0], pitch=-0.3)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: the suite runs several workers
    on one machine's cores, where eight threads a worker thrash."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _gbuffers_equal(a: dict, b: dict) -> bool:
    wide = lambda t: t.to(torch.int32) if t.dtype == torch.uint16 else t
    return set(a) == set(b) and all(torch.equal(wide(a[k]), wide(b[k])) for k in b)


@pytest.mark.parametrize("tracer", TRACERS)
def test_frames_equal_eager_across_world_events(tracer):
    """A region move (on the volume tracers a streamed slab), an edit
    (the volume tracers) and a teleport: every frame of the program equals
    the twin's eager frame, the pipeline keeps its world in the program's
    buffers, and a frame held across later draws is unchanged."""
    pipe = Pipeline(width=SIZE, height=SIZE, device="cpu", tracer=tracer)
    twin = Pipeline(width=SIZE, height=SIZE, device="cpu", tracer=tracer)
    cam = _camera()
    for p in (pipe, twin):
        p.teleport(cam)
    events = ["frame", "move", *(["edit"] if tracer in VOLUME_TRACERS else []), "teleport"]
    held = None
    for event in events:
        if event == "move":
            cam.origin[0] += 25.0  # past a slice: one move
        if event == "edit":  # a snow wall across the view
            depth = pipe.gbuffers["depth"].to(torch.int32)
            for p in (pipe, twin):
                p.edit_box((int(cam.origin[0]) - 40, -80, 40), (80, 4, 40), 6)
        if event == "teleport":
            cam.origin[0] += 600.0
            for p in (pipe, twin):
                p.teleport(cam)
        lr = pipe.streamer.get_render_offset()
        frame = pipe.draw_frame(cam, 0.6)
        want = eager_frame(twin, cam, 0.6)
        assert pipe.uniforms.lr == twin.uniforms.lr
        assert (pipe.uniforms.lr != lr) == (event == "move"), event
        assert torch.equal(frame, want), event
        assert _gbuffers_equal(pipe.gbuffers, twin.gbuffers), event
        if event == "edit":
            assert (pipe.gbuffers["depth"].to(torch.int32) != depth).any()
        if held is None:
            held, held_copy = frame, frame.clone()
    assert torch.equal(held, held_copy)
    (key, program), = pipe._programs.items()
    assert key == (tracer, SIZE, SIZE, pipe.max_steps, pipe.seed, pipe.bounces)
    kept = frame_graph._leaves(pipe.world())
    assert all(a is b for a, b in zip(kept, frame_graph._leaves(program.world)))


def _packed(lr):
    return torch.tensor([-30.0, -100.0, 60.0, 0.0, 0.955, -0.296, 0.0, 0.118, 0.382,
                         0.4, 0.0, 0.0, 0.6, 3.0, lr[0], lr[2]])


def test_refresh_copies_a_new_world_in():
    """A program built on one region's tables renders another region's
    once refreshed with them, and its buffers are the first world's
    tensors, not copies ("hf": the fused program builds its own)."""
    bn = torch.from_numpy(get_blue_noise_f32())
    a = build_hf_tables((0, 0, 0), device="cpu")
    b = build_hf_tables((64, 0, -48), device="cpu")
    program = frame_graph.FrameProgram(a, bn, "hf", SIZE, SIZE)
    assert all(program.world[k] is a[k] for k in a)
    want_a = render_frame_packed(a, bn, _packed((0, 0, 0)), SIZE, SIZE, tracer="hf")[0]
    assert torch.equal(program.run(_packed((0, 0, 0)))[0], want_a)
    want_b = render_frame_packed(b, bn, _packed((64, 0, -48)), SIZE, SIZE, tracer="hf")[0]
    program.refresh(b)
    assert all(torch.equal(program.world[k], b[k]) for k in b)
    got_b = program.run(_packed((64, 0, -48)))[0]
    assert torch.equal(got_b, want_b) and not torch.equal(got_b, want_a)


def test_refresh_raises_on_a_changed_layout():
    bn = torch.from_numpy(get_blue_noise_f32())
    tables = build_hf_tables((0, 0, 0), device="cpu")
    program = frame_graph.FrameProgram(tables, bn, "hf", SIZE, SIZE)
    with pytest.raises(ValueError, match="layout changed"):
        program.refresh(dict(tables, h3=tables["h3"][:-1]))
    with pytest.raises(ValueError, match="layout changed"):
        program.refresh(dict(tables, h3=tables["h3"].to(torch.int64)))
    with pytest.raises(ValueError, match="layout changed"):
        program.refresh({k: v for k, v in tables.items() if k != "cA"})
    with pytest.raises(ValueError, match="unknown tracer"):
        frame_graph.FrameProgram(torch.zeros(8), bn, "raster", SIZE, SIZE)
    # The exact DDA's world is the volume alone.
    volume = frame_graph.FrameProgram(torch.zeros(256 ** 3, dtype=torch.int32), bn, "volume",
                                      SIZE, SIZE)
    with pytest.raises(ValueError, match="layout changed"):
        volume.refresh(torch.zeros(256 ** 3, dtype=torch.int64))
    # The fused program takes no world and no refresh: it builds its tables.
    with pytest.raises(ValueError, match="builds its own"):
        frame_graph.FrameProgram(with_column_heights(tables), bn, "fused", SIZE, SIZE)
    fused = frame_graph.FrameProgram(None, bn, "fused", SIZE, SIZE)
    with pytest.raises(ValueError, match="rebuilds its tables"):
        fused.refresh(with_column_heights(tables))


def test_validate_and_the_exact_dda_stay_eager(capsys):
    """``validate`` frames, the exact DDA's among them, run
    ``render_frame_packed`` op by op: no frame program is built for them.  Without ``validate``
    every tracer, the exact DDA too, has its frame program."""
    cam = _camera()
    checked = Pipeline(width=16, height=16, device="cpu", tracer="hf", validate=True)
    exact = Pipeline(width=16, height=16, device="cpu", tracer="volume", validate=True)
    for p in (checked, exact):
        frame = p.draw_frame(cam, 0.6)
        assert frame.shape == (16, 16, 3) and bool(torch.isfinite(frame).all())
        assert p._programs == {}
    for tracer in ("hf", "volume"):
        graphed = Pipeline(width=16, height=16, device="cpu", tracer=tracer)
        graphed.draw_frame(cam, 0.6)
        assert len(graphed._programs) == 1
    capsys.readouterr()


def test_fused_frame_matches_the_jax_fast_path():
    """One 32² fused frame of a CPU pipeline (its frame program) against
    the JAX pipeline's one-dispatch fast path (``_rffp_impl``, its Pallas
    kernels in interpret mode) at the same camera."""
    ours = Pipeline(width=SIZE, height=SIZE, device="cpu")
    # A zero volume only stands in for the JAX pipeline's initial region:
    # the fused tracer renders the heightfield.
    theirs = jax_pipeline.Pipeline(width=SIZE, height=SIZE, tracer="fused",
                                   preloaded_volume=jnp.zeros(256 ** 3, jnp.uint32))
    assert ours.tracer == "fused" and not theirs.validate
    frame = ours.draw_frame(_camera(), 0.6)
    want = np.asarray(theirs.draw_frame(_camera(JaxCamera), 0.6))
    assert len(ours._programs) == 1
    assert ours.uniforms.lr == theirs.uniforms.lr and ours.uniforms.seed == theirs.uniforms.seed
    stats = compare_images(frame.numpy(), want)
    print(stats)
    assert stats["ok"], stats


def test_fused_program_rebuilds_its_tables_across_a_crossing(monkeypatch):
    """A CPU fused program run on packed vectors that differ only in lr (a
    slice crossing): each frame within ``compare_images`` of JAX's
    one-dispatch fast path (``_render_frame_fused_packed``, which rebuilds
    the tables inside it) on the same vector, and the program's table
    buffers equal to ``with_column_heights(build_hf_tables(lr))`` word for
    word.  On the CPU the plain rebuild runs once per lr: the program's key
    says which region its buffers hold."""
    regions = [(0, 0, 0), (16, 0, 0)]
    want_tables = [with_column_heights(build_hf_tables(lr, device="cpu")) for lr in regions]
    built = []
    plain = hf_tables.build_hf_tables_plain
    monkeypatch.setattr(hf_tables, "build_hf_tables_plain",
                        lambda lr, *a, **k: built.append(lr) or plain(lr, *a, **k))
    bn = torch.from_numpy(get_blue_noise_f32())
    program = frame_graph.FrameProgram(None, bn, "fused", SIZE, SIZE)
    jax_bn = jnp.asarray(get_blue_noise_f32())
    for lr, want in zip(regions, want_tables):
        packed = _packed(lr)
        frame = program.run(packed)[0]
        theirs = np.asarray(jax_pipeline._render_frame_fused_packed(
            jax_bn, jnp.asarray(packed.numpy()), SIZE, SIZE, MAX_TRACE_STEPS, 0, 2))
        stats = compare_images(frame.numpy(), theirs)
        print(lr, stats)
        assert stats["ok"], (lr, stats)
        assert set(program.world) == set(want)
        assert all(torch.equal(program.world[k], want[k]) for k in want), lr
    again = _packed(regions[-1])
    again[12] = 0.9  # another sun, the same region
    assert not torch.equal(program.run(again)[0], frame)
    assert built == regions
    assert program.key.tolist() == [16, 0, 0, 1]


def test_fused_program_builds_its_tables_on_each_change(monkeypatch):
    """A CPU fused program run on lr A, A, B, A, then on A under another
    seed (the program's seed set anew over the same buffers and key): the
    plain build runs exactly on each change of lr or seed, the program's
    tables then equal a fresh build's word for word, each frame is within
    ``compare_images`` of JAX's one-dispatch fast path at that lr and seed,
    a frame of an unchanged lr equals the one before it, and the key holds
    ``(lr.x, lr.y, seed, 1)``."""
    a, b = (0, 0, 0), (16, 0, 0)
    steps = [(a, 0), (a, 0), (b, 0), (a, 0), (a, 7)]
    fresh = {step: with_column_heights(build_hf_tables(*step, device="cpu"), step[1])
             for step in steps}
    built = []
    plain = hf_tables.build_hf_tables_plain
    monkeypatch.setattr(hf_tables, "build_hf_tables_plain",
                        lambda lr, seed=0, *a: built.append((tuple(lr), seed))
                        or plain(lr, seed, *a))
    bn = torch.from_numpy(get_blue_noise_f32())
    program = frame_graph.FrameProgram(None, bn, "fused", SIZE, SIZE)
    assert program.key.tolist() == [0, 0, 0, 0]
    jax_bn = jnp.asarray(get_blue_noise_f32())
    want_built, last = [], None
    for lr, seed in steps:
        changed = last is None or (lr, seed) != last[0]
        program.config = (*program.config[:3], seed, *program.config[4:])
        packed = _packed(lr)
        frame = program.run(packed)[0]
        want_built += [(lr, seed)] if changed else []
        assert built == want_built, (lr, seed)
        if not changed:
            assert torch.equal(frame, last[1])
        want = fresh[lr, seed]
        assert all(torch.equal(program.world[k], want[k]) for k in want), (lr, seed)
        assert program.key.tolist() == [lr[0], lr[1], seed, 1]
        theirs = np.asarray(jax_pipeline._render_frame_fused_packed(
            jax_bn, jnp.asarray(packed.numpy()), SIZE, SIZE, MAX_TRACE_STEPS, seed, 2))
        stats = compare_images(frame.numpy(), theirs)
        print(lr, seed, stats)
        assert stats["ok"], (lr, seed, stats)
        last = ((lr, seed), frame)
