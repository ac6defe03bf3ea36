"""Work of the fused GSS kernel (``kernels/gss_stream.py`` ->
``csrc/gss_stream.cu``) in one chunk of B streams: each stream's audio in
and out (``yardstick.fused_bytes``), the shared A^H of the U = B control
rows, W in and out; the analysis and synthesis FFTs
(``yardstick.fused_fft_flops``) and, per gated (frame, bin) pair, the
demixing update at S slots, 8 M (3 S + 2 S^2) + 4 M operations."""

from portbench import yardstick


def chunk_work(run, pairs: int):
    if run.node != "gss":
        return None
    b, m, t, nib, hop = run.b, run.m, run.t, run.nib, run.hop
    s = 1 + len(run.cfg.get("interference_angles", []))
    ctrl = b * s * m * nib
    state = b * nib * s * m
    nbytes = (b * yardstick.fused_bytes(m, t, hop, 0, 0) + 8 * ctrl
              + 16 * state)
    flops = (b * yardstick.fused_fft_flops(m, t, hop)
             + pairs * (8 * m * (3 * s + 2 * s * s) + 4 * m))
    return nbytes, flops
