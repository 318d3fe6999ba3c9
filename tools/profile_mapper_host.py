"""Profile the mapper's HOST stages (seed + host_tier) without a device.

The device verify is stubbed out so this isolates the host-side work
that tools/run_scale_configs.py's stage_s records.  Run on any host:

    JAX_PLATFORMS=cpu python tools/profile_mapper_host.py [--reads N]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tools.run_scale_configs import simulate  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=262_144)
    ap.add_argument("--ref-mbp", type=float, default=64.0)
    ap.add_argument("--chunk", type=int, default=131_072)
    args = ap.parse_args()

    import mgl_tpu.pipelines.mapper as mapper
    from mgl_tpu.utils.metrics import METRICS

    rng = np.random.default_rng(0)
    ref, reads, true_pos = simulate(rng, int(args.ref_mbp * 1e6),
                                    args.reads, 150)
    t0 = time.time()
    index = mapper.ReferenceIndex.build(ref, k=16)
    print(f"index build: {time.time()-t0:.2f}s", flush=True)

    # stub the device verify: host stages run exactly as in production,
    # the device part returns instantly
    def fake_async(index, starts, reads, wlen, params, impl="auto"):
        B = len(starts)
        return np.zeros(B, np.int32), B

    mapper._sw_score_windows_async = fake_async

    for rep in range(2):
        METRICS.reset()
        t0 = time.time()
        out = mapper.map_reads_stream(index, reads, chunk=args.chunk)
        dt = time.time() - t0
        snap = METRICS.snapshot()["timers_s"]
        stages = {k.split(".", 1)[1]: round(v, 2)
                  for k, v in snap.items() if k.startswith("map.")}
        print(f"pass {rep}: host-only map {dt:.2f}s "
              f"({args.reads/dt:.0f} reads/s host-bound) stages={stages}",
              flush=True)


if __name__ == "__main__":
    main()
