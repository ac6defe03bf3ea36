"""Live monitor for the spec-DOA objective.

The reference's energy2theta-spec.py keeps an interactive matplotlib figure
open while the node runs and scatters three per-step series of the "history"
objective onto a fixed axis (energy2theta-spec.py:32-34 sets
``plt.axis([0, 300, -0.2, 0.2]); plt.ion()``; :91-95 plots the newest-window
rms in blue, the delta against the deque mean in red and the normalized
energy in green, then ``plt.pause(0.0001)``).

This port keeps the exact series and axis but is headless-safe: when no
display is available matplotlib renders on the Agg backend and the figure
is written to disk on :meth:`save` / :meth:`close` instead of shown.
When matplotlib is missing entirely the monitor degrades to pure series
recording so the DOA loop never depends on plotting. (The reference's
spectrogram-mode ``pcolormesh`` is commented out in the script,
energy2theta-spec.py:68-70, so it is not reproduced.)
"""

from __future__ import annotations

import os
from typing import List, Optional


class SpecDoaMonitor:
    """Per-step scatter of (rms, delta, energy) like energy2theta-spec.py.

    Parameters
    ----------
    out_path:
        Where to write the figure when :meth:`save`/:meth:`close` runs
        (headless mode). ``None`` keeps the figure in memory only.
    interactive:
        Force the reference's ``plt.ion()`` live-window behavior. Default
        ``None`` auto-detects: interactive only when a display exists.
    xlim:
        Fixed x-axis extent, 300 steps in the reference
        (energy2theta-spec.py:32).
    """

    def __init__(self, out_path: Optional[str] = None,
                 interactive: Optional[bool] = None, xlim: int = 300):
        self.rms_series: List[float] = []
        self.delta_series: List[float] = []
        self.energy_series: List[float] = []
        self.out_path = out_path
        self._i = 0
        self._plt = None
        self._interactive = False
        try:
            import matplotlib
            has_display = bool(os.environ.get("DISPLAY")
                               or os.environ.get("WAYLAND_DISPLAY"))
            if interactive is None:
                interactive = has_display
            if not has_display:
                matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:          # matplotlib absent: record-only mode
            return
        self._plt = plt
        self._fig, self._ax = plt.subplots()
        # the reference's fixed viewport (energy2theta-spec.py:32)
        self._ax.axis([0, xlim, -0.2, 0.2])
        self._interactive = bool(interactive)
        if self._interactive:
            plt.ion()

    @property
    def plotting(self) -> bool:
        return self._plt is not None

    def update(self, rms_val: float, delta: float, energy: float) -> None:
        """One objective evaluation: the three scatter points of
        energy2theta-spec.py:91-95."""
        self.rms_series.append(float(rms_val))
        self.delta_series.append(float(delta))
        self.energy_series.append(float(energy))
        if self._plt is None:
            return
        self._ax.scatter(self._i, rms_val, c="b")
        self._ax.scatter(self._i, delta, c="r")
        self._ax.scatter(self._i, energy, c="g")
        if self._interactive:
            self._plt.pause(0.0001)     # energy2theta-spec.py:95
        self._i += 1

    def save(self, path: Optional[str] = None) -> Optional[str]:
        """Write the accumulated figure (headless replacement for the live
        window). Returns the written path, or None in record-only mode."""
        path = path or self.out_path
        if self._plt is None or path is None:
            return None
        self._fig.savefig(path)
        return path

    def close(self) -> None:
        if self._plt is None:
            return
        self.save()
        self._plt.close(self._fig)
        self._plt = None
