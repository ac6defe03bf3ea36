"""Work of MVDR's stream solve (``kernels/mvdr_stream.py`` ->
``csrc/mvdr_stream.cu``) in one chunk of B streams: each stream's in-band
spectra and history read once, the steering of the U = B directions, the
gated output and gate written; the sliding covariances of every stream and
the solves of the ``pairs`` gated (frame, bin) problems
(``yardstick.solve_flops``)."""

from portbench import yardstick


def chunk_work(run, pairs: int):
    if run.node != "mvdr" or run.cfg["params"].get("solver") == "mega":
        return None
    w = int(run.cfg["params"]["past_windows"])
    b, m, t, nib = run.b, run.m, run.t, run.nib
    nbytes = b * (8 * (t + w) * m * nib + 9 * t * nib) + 8 * b * m * nib
    flops = (yardstick.solve_flops(pairs, m, t, w, nib)
             + (b - 1) * yardstick.solve_flops(0, m, t, w, nib))
    return nbytes, flops
