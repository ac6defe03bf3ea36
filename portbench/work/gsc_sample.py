"""Work of GSC's per-sample adaptive stage (``kernels/gsc.py`` ->
``csrc/gsc_sample.cu``, the ``sample`` route) in one chunk of B streams:
each stream's M aligned channels in and its output out, and the blocking,
filter and output registers (C = M - 1 channels of K taps, K outputs) in
and out, float32; per stream-sample the dot product of the C filters with
the blocking registers and the update of the C*K taps (a multiply and an
add each), 4 C K operations. Other nodes and routes: None."""


def chunk_work(run, pairs: int):
    p = run.cfg["params"]
    if run.node != "gsc" or not (p.get("write_mu")
                                 or p.get("solver", "sample") == "sample"):
        return None
    b, m, s = run.b, run.m, run.t * run.hop
    c, k = m - 1, int(p["filter_size"])
    nbytes = 4 * (b * m * s + b * s) + 2 * 4 * (2 * b * c * k + b * k)
    return nbytes, 4 * c * k * b * s
