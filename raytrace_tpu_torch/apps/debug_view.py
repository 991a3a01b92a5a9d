"""Debug viewer: dump the blue-noise texture (and G-buffers) as PNGs.

Port of ``raytrace_tpu/apps/debug_view.py:17-57``: parity with the
reference's unused ``test.comp`` blue-noise debug shader
(shaders/glsl/test.comp) plus a G-buffer inspector, which renders the
canonical view at 512² through the staged heightfield tracer
(``render_gbuffers_hf``: K4 on the card).

Usage: python -m raytrace_tpu_torch.apps.debug_view [--out /tmp/rt_debug]
[--gbuffers]   (needs a CUDA GPU)
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..ops.hf_tables import build_hf_tables
from ..ops.trace_hf import render_gbuffers_hf
from ..render.camera import Camera
from ..testing.golden import save_png
from ..utils.blue_noise import get_blue_noise, get_blue_noise_f32

SIZE = 512


def run(out_dir: str = "/tmp/rt_debug", gbuffers: bool = False, device="cuda") -> dict:
    """Write the PNGs; -> the G-buffers (on ``device``) when ``gbuffers``.
    ``device``: "cuda" raises without a GPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("debug_view needs a CUDA GPU")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    bn = get_blue_noise()
    save_png(out / "blue_noise_rgb.png", bn[:, :, :3] / 255.0)
    save_png(out / "blue_noise_r.png", np.repeat(bn[:, :, :1], 3, -1) / 255.0)

    gb = None
    if gbuffers:
        tables = build_hf_tables((0, 0, 0), seed=0, device=device)
        cam = Camera(origin=[-30.0, -100.0, 60.0], pitch=-0.3)
        fwd, up, right = cam.scaled_basis()
        vec = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        uni = dict(origin=vec(cam.origin), forward=vec(fwd), up=vec(up), right=vec(right),
                   sun_angle=vec(0.6), seed=torch.tensor(7, dtype=torch.int32, device=device),
                   lr=vec([0.0, 0.0, 0.0]))
        bnf = torch.from_numpy(get_blue_noise_f32()).to(device)
        gb = render_gbuffers_hf(tables, bnf, uni, SIZE, SIZE, 1024, 0)
        host = lambda k: gb[k].cpu().numpy()
        save_png(out / "gb_albedo.png", host("albedo"))
        save_png(out / "gb_lighting.png", host("lighting") * 4.0)
        save_png(out / "gb_fog.png", host("fog"))
        depth = gb["depth"].to(torch.int32).cpu().numpy().astype(np.float32) / 65535.0
        save_png(out / "gb_depth.png", np.repeat(depth[..., None], 3, -1))
        normal = host("normal").astype(np.float32) / 16.0
        save_png(out / "gb_normal.png", np.repeat(normal[..., None], 3, -1))
    print(f"debug views written to {out}")
    return gb


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="/tmp/rt_debug")
    ap.add_argument("--gbuffers", action="store_true")
    ns = ap.parse_args()
    run(ns.out, ns.gbuffers)


if __name__ == "__main__":
    main()
