"""The card's idle time (no kernel, copy or memset) inside the program's
``bf.process`` spans, over the window's chunks (ms): the host's enqueue
with the card waiting, without the harness's loop and copy wait, which
``device_idle_pct`` also counts."""

from portbench.metrics._spans import chunks, idle_inside


def read(run):
    found = chunks(run)
    if found is None:
        return None
    procs = found[0]
    busy = run.trace.busy_intervals()
    inside = idle_inside(busy, procs)
    idle = (run.trace.w1 - run.trace.w0) - sum(e - s for s, e in busy)
    run.log(f"process_idle: {len(procs)} bf.process spans, {run.chunks} "
            f"chunks; idle {inside * 1e-6:.6f} s inside them, "
            f"{(idle - inside) * 1e-6:.6f} s outside, of "
            f"{run.trace.window_s:.6f} s")
    return inside / len(procs) * 1e-3
