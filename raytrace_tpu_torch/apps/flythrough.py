"""Interactive / scripted renderer loop.

Port of ``raytrace_tpu/apps/flythrough.py:27-260``.  Reference:
src/bin/main.rs: event loop, tick + draw_frame, rolling avg/max ms HUD
(main.rs:41-54).  Headless: the "window" is PNG frame dumps or a pure
frame loop; input is a scripted key timeline or the terminal (the
reference's control names: w/a/s/d/q/e movement, r/f sun; on a volume
tracer b places a box and x carves one).

Usage:
  python -m raytrace_tpu_torch.apps.flythrough [x y z heading pitch sun]
      [--frames N] [--size WxH] [--dump-every K] [--out DIR]
      [--tracer fused|hf|volume|volume_fast] [--interactive]
(needs a CUDA GPU)
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..engine.game import Game
from ..render.camera import compute_triple_euler_vector
from ..render.pipeline import VOLUME_TRACERS, Pipeline
from ..testing.golden import save_png
from ..utils.perf import RingBufferAverage


class TerminalInput:
    """Live keyboard input from a raw-mode terminal (the headless stand-in
    for the reference's winit KeyboardInput events, main.rs:20-37).

    A terminal delivers key-down bytes only (no key-up), so each received
    key counts as held for `hold_frames` frames — long enough that OS
    key-repeat (~30 Hz) keeps a held key continuously active at interactive
    frame rates.  ESC or Ctrl-C exits.
    """

    KEYS = "wasdqerfbx"

    def __init__(self, hold_frames: int = 4):
        import sys
        import termios
        import tty

        self._fd = sys.stdin.fileno()
        self._saved = termios.tcgetattr(self._fd)
        tty.setcbreak(self._fd)
        self._hold = {k: 0 for k in self.KEYS}
        self._hold_frames = hold_frames
        self.quit = False

    def restore(self) -> None:
        import termios

        termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)

    def pump(self, controls) -> None:
        """Drain pending bytes, press newly-active keys, release expired."""
        import select
        import sys

        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch in ("\x1b", "\x03"):  # ESC / Ctrl-C
                self.quit = True
            elif ch.lower() in self._hold:
                self._hold[ch.lower()] = self._hold_frames
        for key, frames in self._hold.items():
            if frames > 0:
                controls.on_pressed(key)
                self._hold[key] = frames - 1
            else:
                controls.on_released(key)


def run(
    args=None,
    frames: int = 120,
    width: int = 1024,
    height: int = 1024,
    dump_every: int = 0,
    out_dir: str = "frames",
    script=None,
    max_steps: int = 2048,
    quiet: bool = False,
    interactive: bool = False,
    bounces: int = 2,
    tracer: str | None = None,
):
    """Run the frame loop; returns (last_frame, avg_ms, max_ms).

    `script` is an optional list of (frame_index, event, key) tuples, e.g.
    [(0, "press", "w"), (60, "release", "w")].  `interactive` reads live
    w/a/s/d/q/e/r/f keys from the terminal instead (ESC quits); on a
    volume-tracer pipeline (tracer="volume_fast"), `b` places a material
    box ahead of the camera and `x` carves one (Pipeline.edit_box).
    """
    game = Game(args)
    t0 = time.monotonic()
    pipeline = Pipeline(
        width=width, height=height, max_steps=max_steps, bounces=bounces,
        tracer=tracer,
    )
    if not quiet:
        print(f"Created renderer (and world) in {time.monotonic() - t0:.2f}s.")

    term = TerminalInput() if interactive else None
    script = sorted(script or [], key=lambda e: e[0])
    perf = RingBufferAverage(120)
    frame = None
    try:
        frame = _loop(
            game, pipeline, frames, dump_every, out_dir, script, quiet,
            perf, term,
        )
    finally:
        if term is not None:
            term.restore()
    # Read the last frame back (a wait for the device).  Interactive ESC
    # before the first frame renders leaves no frame at all: None.
    if frame is None:
        return None, perf.average(), perf.max()
    frame = frame.cpu().numpy()
    if not quiet:
        print()
    return frame, perf.average(), perf.max()


EDIT_REACH = 24.0  # edit box center this far along the camera forward
EDIT_SIZE = 6
EDIT_MATERIAL = 3


def _maybe_edit(game, pipeline, quiet) -> None:
    """Consume place/carve key edges: write a small box ahead of the
    camera (Pipeline.edit_box).  Heightfield-tracer pipelines cannot
    display edits; say so once instead of raising out of the loop."""
    place = game.controls.is_pressed("place")
    carve = game.controls.is_pressed("carve")
    if not (place or carve):
        return
    if pipeline.tracer not in VOLUME_TRACERS:
        if not quiet and not getattr(game, "_edit_hint_shown", False):
            game._edit_hint_shown = True
            print(
                "\n[edit] tracer="
                f"{pipeline.tracer!r} cannot display edits; rerun with "
                "--tracer volume_fast"
            )
        return
    fwd, _, _ = compute_triple_euler_vector(
        game.camera.heading, game.camera.pitch
    )
    n = sum(c * c for c in fwd) ** 0.5
    mn = tuple(
        int(np.floor(o + EDIT_REACH * c / n)) - EDIT_SIZE // 2
        for o, c in zip(game.camera.origin, fwd)
    )
    try:
        pipeline.edit_box(
            mn, (EDIT_SIZE,) * 3, EDIT_MATERIAL if place else None
        )
        if not quiet:
            print(f"\n[edit] {'placed' if place else 'carved'} box at {mn}")
    except ValueError as e:  # outside the resident window
        if not quiet:
            print(f"\n[edit] rejected: {e}")


def _loop(game, pipeline, frames, dump_every, out_dir, script, quiet, perf,
          term):
    script_pos = 0
    frame_timer = time.monotonic()
    frame = None
    for i in range(frames):
        if term is not None:
            term.pump(game.controls)
            if term.quit:
                break
        while script_pos < len(script) and script[script_pos][0] <= i:
            _, event, key = script[script_pos]
            (game.controls.on_pressed if event == "press" else game.controls.on_released)(key)
            script_pos += 1

        millis = (time.monotonic() - frame_timer) * 1000.0
        frame_timer = time.monotonic()
        perf.push_sample(millis)
        # Simulation dt is clamped: a stall (the first frame's kernel build)
        # must not advance the fly camera / sun by seconds of game time in
        # one tick.  (The reference ticks real dt, main.rs:43.)
        millis = min(millis, 100.0)
        if not quiet:
            print(f"\r{perf.average():.1f}ms / {perf.max():.1f}ms   ", end="", flush=True)

        game.tick(millis / 1000.0)
        _maybe_edit(game, pipeline, quiet)
        frame = pipeline.draw_frame(game.camera, game.get_sun_angle())
        game.controls.tick()

        if dump_every and (i % dump_every == 0):
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            save_png(Path(out_dir) / f"frame_{i:05d}.png", frame.cpu().numpy())
    return frame


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("camera", nargs="*", help="x y z heading pitch sun_angle")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--size", default="1024x1024")
    ap.add_argument("--dump-every", type=int, default=0)
    ap.add_argument("--out", default="frames")
    ap.add_argument("--max-steps", type=int, default=2048)
    ap.add_argument(
        "--bounces", type=int, default=2, choices=(0, 1, 2),
        help="light-path depth; 1 = interactive preset (3 rays/px)",
    )
    ap.add_argument(
        "--interactive", action="store_true",
        help="live w/a/s/d/q/e movement + r/f sun from the terminal "
        "(ESC quits); replaces the default scripted flight.  On "
        "--tracer volume_fast, b places a block box and x carves one",
    )
    ap.add_argument(
        "--tracer", default=None,
        choices=("fused", "hf", "volume", "volume_fast"),
        help="frame tracer (default: the fused heightfield fast path; "
        "volume_fast enables world editing)",
    )
    ns = ap.parse_args()
    w, h = map(int, ns.size.split("x"))
    camera = ns.camera if len(ns.camera) == 6 else None
    # Default scripted flight: forward with a slow sun sweep.
    script = (
        None
        if ns.interactive
        else [(0, "press", "w"), (0, "press", "r"), (40, "release", "r")]
    )
    run(
        camera,
        frames=ns.frames,
        width=w,
        height=h,
        dump_every=ns.dump_every,
        out_dir=ns.out,
        script=script,
        max_steps=ns.max_steps,
        interactive=ns.interactive,
        bounces=ns.bounces,
        tracer=ns.tracer,
    )


if __name__ == "__main__":
    main()
