"""The measured window: frames enqueued back to back, timed on the device.

A driver (``drivers/``) renders frame after frame; the window
- holds at most ``in_flight`` frames queued on the card (before enqueuing
  a frame it waits for the completion of the frame ``in_flight`` back), as
  an interactive client that shows each frame does;
- counts a frame as failed when any of its primary pixels ran out of step
  budget or any value of the frame is not finite (``FrameChecks``: three
  launches a frame, read once when the window has closed);
- records a CUDA event after each frame: a frame's interval is the time
  from the previous frame's completion to its own;
- copies the frames it is to check (``Snapshots``) into buffers made in
  set-up, so nothing is allocated in the window;
- with a ``Profile``, traces the frames ``skip .. skip + count`` (and
  runs on past ``seconds`` until they are done).

On a CPU (the rehearsal of the tests) each frame is complete when its call
returns, and the host clock stands in for the events.
"""

from __future__ import annotations

import contextlib
import random
import time

import numpy as np
import torch

from . import timeline


class Clock:
    """Completion times of frames: CUDA events on the card, the host clock
    on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.start = self._mark()

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def frame_done(self) -> None:
        self.marks.append(self._mark())

    def wait_for(self, i: int) -> None:
        """Wait until frame ``i`` is complete."""
        if self.cuda:
            self.marks[i].synchronize()

    def completions_ms(self) -> list:
        """Each frame's completion, in ms from the window's start (all
        frames complete)."""
        if not self.cuda:
            return [(t - self.start) * 1e3 for t in self.marks]
        return [self.start.elapsed_time(e) for e in self.marks]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Snapshots:
    """Copies of the frames that the check compares, drawn from the seed:
    ``count`` frame indices below ``within``, the first of them moved on to
    the next frame whose draw moved the region (a streamed slice).  The buffers are made in set-up from a drawn
    frame, so copying allocates nothing."""

    def __init__(self, driver, frame: torch.Tensor, seed: int, count: int, within: int):
        rng = random.Random(seed)
        self.due = sorted(rng.sample(range(within), count))
        self.crossing = self.due[0]  # waits for a slice
        self.taken = []
        self.free = [self._buffers(driver, frame) for _ in range(count)]

    @staticmethod
    def _buffers(driver, frame):
        clone = lambda t: torch.empty_like(t)
        return dict(frame=clone(frame),
                    world={k: clone(v) for k, v in driver.world().items()},
                    gbuffers={k: clone(v) for k, v in driver.gbuffers().items()})

    def maybe_take(self, i: int, crossed: bool, driver, frame: torch.Tensor) -> None:
        if not self.due or i < self.due[0] or (self.due[0] == self.crossing and not crossed):
            return
        self.due.pop(0)
        snap = self.free.pop()
        snap["frame"].copy_(frame)
        for key in ("world", "gbuffers"):
            for k, v in getattr(driver, key)().items():
                snap[key][k].copy_(v)
        snap["packed"] = np.array(driver.packed(), np.float32)
        snap["index"] = i
        self.taken.append(snap)


class FrameChecks:
    """Whether each frame failed: a primary pixel whose depth is
    ``exhausted_depth`` (its step budget ran out), or a value of the frame
    that is not finite.  Three launches a frame (the depth compared, its
    ``any``, the frame's sum), each result written into buffers made in
    set-up (``CHUNK`` frames each, one more buffer pair every ``CHUNK``
    frames), and nothing read until the window has closed."""

    CHUNK = 8192

    def __init__(self, driver, frame: torch.Tensor, exhausted_depth: int):
        self.device = frame.device
        self.exhausted_depth = exhausted_depth
        self.chunks = []
        self.n = 0
        self.add(driver, frame)  # set-up's one check: every launch's first
        self.n = 0

    def _buffers(self) -> tuple:
        return (torch.zeros(self.CHUNK, dtype=torch.bool, device=self.device),
                torch.zeros(self.CHUNK, dtype=torch.float32, device=self.device))

    def add(self, driver, frame: torch.Tensor) -> None:
        k, i = divmod(self.n, self.CHUNK)
        if k == len(self.chunks):
            self.chunks.append(self._buffers())
        exhausted, sums = self.chunks[k]
        depth, value = driver.gbuffers()["depth"], self.exhausted_depth
        if depth.dtype == torch.uint16:  # compared as the int16 of the same bits
            depth, value = depth.view(torch.int16), value - (value >> 15 << 16)
        torch.any(torch.eq(depth, value), out=exhausted[i])
        torch.sum(frame.view(-1), 0, out=sums[i])
        self.n += 1

    def failed(self) -> int:
        """Frames that failed, of those checked since set-up."""
        total = 0
        for k, (exhausted, sums) in enumerate(self.chunks):
            m = min(self.CHUNK, self.n - k * self.CHUNK)
            if m > 0:
                total += int((exhausted[:m] | ~torch.isfinite(sums[:m])).sum())
        return total


class Profile:
    """``torch.profiler`` over frames ``skip .. skip + count`` of the
    window, with the harness's host spans (``span``) in its timeline."""

    SPANS = ("draw_frame", "frame_checks", "wait_in_flight")

    def __init__(self, skip: int, count: int):
        self.skip, self.count = skip, count
        self.prof = None
        self.active = False
        self.device_ops = []  # (name, start_us, end_us)
        self.host_spans = []  # (name, start_us, end_us)

    def warm(self, draw, device: torch.device) -> None:
        """Set-up's profile of one frame ``draw()``: the profiler's first
        start (which loads its tracing library) stays out of the window."""
        self.prof = torch.profiler.profile(activities=self._activities(device))
        self.prof.start()
        draw()
        sync(device)
        self.prof.stop()
        self.prof = None

    @staticmethod
    def _activities(device: torch.device) -> list:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return activities

    @property
    def pending(self) -> bool:
        """Whether the traced frames are still to come or under way."""
        return self.active or self.prof is None

    def step(self, i: int, device: torch.device) -> None:
        """Start before frame ``skip``, stop before frame ``skip + count``
        (each after a synchronize, so the trace holds whole frames)."""
        if i == self.skip:
            sync(device)
            self.prof = torch.profiler.profile(activities=self._activities(device))
            self.prof.start()
            self.active = True
        elif i == self.skip + self.count:
            self.finish(device)

    def finish(self, device: torch.device) -> None:
        if not self.active:
            return
        sync(device)
        self.prof.stop()
        self.active = False
        events = self.prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        host_names = {e.name for e in events if e.device_type != cuda}
        for e in events:
            span = (e.time_range.start, e.time_range.end)
            if e.device_type != cuda:
                if e.name in self.SPANS:
                    self.host_spans.append((e.name, *span))
            elif e.name not in host_names:
                # A host range's mark on the device's row (the harness's
                # spans, the collectives' "nccl:..." ranges) is not a device
                # activity: kernels, copies and sets never run on the host.
                self.device_ops.append((e.name, *span))

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)


def run_window(driver, seconds: float, in_flight: int, snapshots: Snapshots | None,
               checks: FrameChecks, profile: Profile | None) -> dict:
    """Frames of ``driver`` for ``seconds`` -> the window's counts and
    times (all frames complete)."""
    device = driver.device
    sync(device)
    clock = Clock(device)
    t0 = time.perf_counter()
    t_end = t0 + seconds
    n = 0
    host_s = host_frames = 0
    span = profile.span if profile is not None else (lambda name: contextlib.nullcontext())
    # A traced run goes on past ``seconds`` until its traced frames are done.
    while time.perf_counter() < t_end or (profile is not None and profile.pending):
        if profile is not None:
            profile.step(n, device)
        if n >= in_flight:
            with span("wait_in_flight"):
                clock.wait_for(n - in_flight)
        lr = driver.lr()
        h0 = time.perf_counter()
        with span("draw_frame"):
            frame = driver.draw()
        h1 = time.perf_counter()
        if profile is None or not profile.active:
            host_s += h1 - h0
            host_frames += 1
        with span("frame_checks"):
            checks.add(driver, frame)
            if snapshots is not None:
                snapshots.maybe_take(n, driver.lr() != lr, driver, frame)
        clock.frame_done()
        n += 1
    if profile is not None:
        profile.finish(device)
    sync(device)
    t1 = time.perf_counter()
    intervals = timeline.intervals([0.0] + clock.completions_ms())
    return dict(frames=n, failed=checks.failed(), window_s=t1 - t0, intervals_ms=intervals,
                host_ms_per_frame=host_s * 1e3 / host_frames if host_frames else None,
                start=t0)
