"""The share of a layer's roofline: the least time of the work the
window's inputs need (``work/<layer>.py``, with the reference's count of
gated pairs) over the profiler's time of the layer's kernels."""


def roofline_pct(run, patterns, layer: str):
    seconds = run.trace.kernel_seconds(patterns) if run.trace else 0.0
    work = run.window_work(layer)
    if not seconds or work is None:
        return None
    least = run.least_seconds(*work)
    if least is None:
        return None
    run.log(f"{layer}: {work[0] / 1e9:.4f} GB, {work[1] / 1e9:.4f} Gflop "
            f"over the window -> least {least[0] * 1e3:.4f} ms, bound by "
            f"{least[1]}; kernels {seconds * 1e3:.4f} ms")
    return 100.0 * least[0] / seconds
