"""Closed-loop steering: beamformer + DOA refiner, chunk by chunk.

The reference closes this loop over ROS topics (beamformer publishes
``jackaudio``, a script publishes ``/theta`` back). Here it is a chunked
driver over a StreamingSession: process a chunk, feed the output windows to
the DOA controller, steer the next chunk with the updated theta.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from beamform_tpu_torch.runtime.streaming import StreamingSession


def run_closed_loop(session: StreamingSession, doa, x,
                    chunk_frames: int = 4,
                    ref_session: Optional[StreamingSession] = None):
    """Run ``x`` (M, S) through the session, updating theta per chunk.

    ``doa``: a GradientDoa (uses the beamformed output) or DiffGradientDoa
    (also needs ``ref_session`` for the aligned reference path). Returns
    (output (S,), theta timeline per frame (T,)), on the host.
    """
    hop = session.hop
    s = x.shape[-1] - x.shape[-1] % (chunk_frames * hop)
    outs, thetas = [], []
    theta = doa.theta
    for i in range(0, s, chunk_frames * hop):
        chunk = x[:, i:i + chunk_frames * hop]
        y = session.process(chunk, theta).cpu().numpy()
        if ref_session is not None:
            r = ref_session.process(chunk[:1]).cpu().numpy()
            for k in range(chunk_frames):
                theta = doa.step(y[k * hop:(k + 1) * hop],
                                 r[k * hop:(k + 1) * hop])
                thetas.append(theta)
        else:
            for k in range(chunk_frames):
                theta = doa.step(y[k * hop:(k + 1) * hop])
                thetas.append(theta)
        outs.append(y)
    return np.concatenate(outs), np.asarray(thetas)
