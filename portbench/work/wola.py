"""Work of the WOLA kernels (``kernels/wola.py`` -> ``csrc/wola.cu``) in one
chunk: the analysis of the B*M channels with each stream's gate statistic,
and the synthesis of the B outputs. Every node but the fused ones (GSS,
and MVDR/LCMV under ``solver: mega``) runs them."""

from portbench import yardstick


def chunk_work(run, pairs: int):
    if run.node == "gss" or run.cfg["params"].get("solver") == "mega":
        return None
    a_b, a_f = yardstick.analysis_work(run.b * run.m, run.t, run.hop,
                                       streams=run.b)
    s_b, s_f = yardstick.synthesis_work(run.b, run.t, run.hop)
    return a_b + s_b, a_f + s_f
