"""What a run loads: no JAX and no JAX package (top-level names compared
whole: the port's name begins with the JAX package's), and a reference
that loads nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys

from h100_bench.spec import ROOT

RUN = """
import json, sys, torch
sys.path.insert(0, "h100_bench/tests")
from rehearsal import rehearse
result, _ = rehearse("fused.fly_1024_b2", seconds=0.3)
assert result["correct"], result
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
from h100_bench.reference import frame as ref
w = ref.world("volume_fast", 5, (0, 0, 48), "cpu")
gb = ref.gbuffers("volume_fast", w, ref.blue_noise("cpu"),
                  ref.uniforms([-30, -100, 60, 0, 1, 0, 0, 0, .4, .4, 0, 0, .6, 3, 0, 48], "cpu"),
                  8, 8, 2048, 5, 2)
ref.finish(gb, ref.blue_noise("cpu"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _top_level(RUN)
    assert "raytrace_tpu_torch" in loaded and "h100_bench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "raytrace_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    loaded = _top_level(REFERENCE)
    assert "h100_bench" in loaded
    assert not loaded & {"raytrace_tpu_torch", "raytrace_tpu", "jax", "jaxlib", "flax"}
