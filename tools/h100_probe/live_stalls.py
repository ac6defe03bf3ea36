#!/usr/bin/env python3
"""Where a live chunk's time goes, on one NVIDIA GPU.

    python3 tools/h100_probe/live_stalls.py

Builds the kernels, then runs DAS on chip_smoke.py's headline input
(aira16, 48 kHz, hop 1024) one hop a chunk, host numpy in, the way
``beamform-tpu-torch das --live`` runs it, and times each chunk's
sections on the host clock: the copy in (pageable, or through a pinned
buffer), the model's launches, the synchronise, the fetch of the output.
Five loops: paced at the audio rate (10 s, twice), paced with the pinned
copy, back to back (30 s), paced again; each line gives the medians, the
max of each section, the five worst chunks with their sections, and every
garbage collection that ran in the loop. Then ``das --live --live-chunk
1`` twice through a subprocess's pipe fed at the audio rate (chip_smoke.py
``live_subprocess``), a chunk with 50 ms of device work queued after its
own timed without a synchronise (what a monitor that did not wait would
read), and nvidia-smi's clocks, power and persistence mode.
"""

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import chip_smoke as cs  # noqa: E402

SECTIONS = "h2d,launch,sync,fetch,total"


def loop(model, x, paced: bool, pinned: bool) -> dict:
    """One hop a chunk over ``x``; per-chunk sections in ms."""
    import torch
    hop = cs.HOP
    n = x.shape[1] // hop
    state = model.stream_init()
    ms = np.zeros((n, 5))
    gcs, start = [], {}

    def on_gc(phase, info):
        if phase == "start":
            start["t"] = time.perf_counter()
        else:
            gcs.append((info["generation"],
                        round((time.perf_counter() - start["t"]) * 1e3, 3)))

    gc.callbacks.append(on_gc)
    buf = torch.empty((16, hop), dtype=torch.float32, pin_memory=True)
    t0 = time.perf_counter()
    try:
        for i in range(n):
            blk = np.ascontiguousarray(x[:, i * hop:(i + 1) * hop])
            if paced:
                delay = t0 + i * hop / cs.FS - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            t = [time.perf_counter()]
            if pinned:
                buf.copy_(torch.from_numpy(blk))
                xd = buf.to("cuda", non_blocking=True)
            else:
                xd = torch.as_tensor(blk).to("cuda")
            t.append(time.perf_counter())
            out, state = model.process_chunk(xd, cs.THETA, state)
            t.append(time.perf_counter())
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            out.cpu().numpy()
            t.append(time.perf_counter())
            ms[i, :4] = np.diff(t) * 1e3
            ms[i, 4] = (t[-1] - t[0]) * 1e3
    finally:
        gc.callbacks.remove(on_gc)
    worst = np.argsort(ms[:, 4])[-5:][::-1]
    return {"paced": paced, "pinned": pinned, "chunks": n,
            "median_total": round(float(np.median(ms[:, 4])), 4),
            "p99_total": round(float(np.percentile(ms[:, 4], 99)), 4),
            f"max ({SECTIONS})": [round(float(v), 3) for v in ms.max(0)],
            f"worst 5 (chunk, {SECTIONS})":
                [[int(i)] + [round(float(v), 3) for v in ms[i]]
                 for i in worst],
            "gc (generation, ms)": gcs}


def main() -> int:
    import torch
    from beamform_tpu_torch.models import get_model
    cs.log(cs.card_line())
    cs.phase("build", cs.phase_build)
    x = cs.make_input(16, cs.SECONDS)
    model = get_model("das", cs.engine(), cs.aira16(), device="cuda")
    loop(model, x[:, :50 * cs.HOP], False, False)          # warm-up
    for paced, pinned, seconds in ((True, False, 10), (True, False, 10),
                                   (True, True, 10), (False, False, 30),
                                   (True, False, 10)):
        cs.log(json.dumps(loop(model, x[:, :int(seconds * cs.FS)], paced,
                               pinned)))
    cfg = os.path.join(cs.ROOT, "beamform_tpu_torch", "configs",
                       "aira16.yaml")
    short = int(10 * cs.FS)
    for _ in range(2):
        _, rep = cs.live_subprocess(cs.live_argv("das", cfg, 1),
                                    np.ascontiguousarray(x[:, :short].T),
                                    paced=True)
        cs.log(f"cli --live-chunk 1, paced: {json.dumps(rep)}")
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    blk = np.ascontiguousarray(x[:, :4 * cs.HOP])
    t = time.perf_counter()
    model.process_chunk(blk, cs.THETA, model.stream_init())
    a.record()
    torch.cuda._sleep(cs.BLOCK_CYCLES)
    b.record()
    host = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    cs.log(f"a chunk with {a.elapsed_time(b):.3f} ms of device work queued "
           f"after its own, without a synchronise: {host:.3f} ms")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "pstate,persistence_mode", "--format=csv"],
        capture_output=True, text=True, timeout=60)
    cs.log(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
