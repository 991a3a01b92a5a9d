"""Named control bindings with edge detection.

A copy of ``raytrace_tpu/engine/controls.py``, whose package imports JAX.

Reference: src/game/control.rs (ControlSet with is_held / is_pressed /
is_released and a per-frame tick that rolls current state into last state).
Key codes here are plain strings (e.g. "w", "q") so the engine is
front-end-agnostic (terminal, recorded scripts, or a windowing layer).
"""

from __future__ import annotations


class _Control:
    __slots__ = ("last_state", "this_state")

    def __init__(self):
        self.last_state = False
        self.this_state = False


class ControlSet:
    def __init__(self):
        self._controls: list[_Control] = []
        self._by_name: dict[str, int] = {}
        self._by_code: dict[str, int] = {}

    def add_control(self, name: str, binding: str) -> None:
        index = len(self._controls)
        self._controls.append(_Control())
        self._by_name[name] = index
        self._by_code[binding] = index

    def tick(self) -> None:
        """Roll state; call once per frame after consuming events."""
        for c in self._controls:
            c.last_state = c.this_state

    def on_pressed(self, code: str) -> None:
        i = self._by_code.get(code)
        if i is not None:
            self._controls[i].this_state = True

    def on_released(self, code: str) -> None:
        i = self._by_code.get(code)
        if i is not None:
            self._controls[i].this_state = False

    def is_held(self, name: str) -> bool:
        i = self._by_name.get(name)
        return self._controls[i].this_state if i is not None else False

    def is_pressed(self, name: str) -> bool:
        i = self._by_name.get(name)
        if i is None:
            return False
        c = self._controls[i]
        return c.this_state and not c.last_state

    def is_released(self, name: str) -> bool:
        i = self._by_name.get(name)
        if i is None:
            return False
        c = self._controls[i]
        return not c.this_state and c.last_state
