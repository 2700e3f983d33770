#!/usr/bin/env python
"""Cross-integrator estimator parity at benchmark scale (PARITY.md evidence).

Renders the same scene with the wavefront integrator and the independent
ground-truth `reference` integrator (gpupathtracer_tpu/render/parity.py),
then reports per-channel mean error and pixelwise agreement.

Usage: python tools/parity.py [--scene proc:cornell] [--res 128]
       [--spp-wave 512] [--spp-ref 2048]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--scene", default="proc:cornell")
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp-wave", type=int, default=512)
    ap.add_argument("--spp-ref", type=int, default=2048)
    ap.add_argument("--skybox", default=None,
                    help="default: WHITE for the env-lit bunny scene "
                         "(it has no emitter), BLACK otherwise")
    ap.add_argument("--frame-batch", type=int, default=1,
                    help="spp per dispatch for the wavefront integrator")
    args = ap.parse_args()

    from gpupathtracer_tpu.render.parity import (estimator_parity,
                                                 parity_config)
    from gpupathtracer_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    cfg = parity_config(args.scene, args.res, args.skybox)
    cfg.frame_batch = args.frame_batch
    out = estimator_parity(cfg, args.spp_wave, args.spp_ref)
    print(f"scene={args.scene} res={args.res} wavefront {args.spp_wave}spp "
          f"vs reference {args.spp_ref}spp")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
