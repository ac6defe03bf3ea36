"""Energy-based voice activity detection.

Replicates scripts/vad.py (the reference's rospy VAD node): a two-flag state
machine (silence / active) over per-window mean-|x| energies with an
adaptive noise floor and an 8-window energy history (vad.py:12-67).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class EnergyVad:
    tchange: float = 0.015
    tvad: float = 0.02
    ehist_len: int = 8
    windows_passed_threshold: int = 5

    state_silence: bool = False
    state_active: bool = False
    enoise: float = 0.0
    windows_passed: int = 0
    _ehist: np.ndarray = field(default=None)
    _ehist_i: int = 0

    def __post_init__(self):
        if self._ehist is None:
            self._ehist = np.zeros(self.ehist_len)

    def step(self, window) -> bool:
        """Feed one output window; returns state_active (vad.py:22-67)."""
        e = float(np.abs(np.asarray(window)).mean())

        if not self.state_silence and e > self.enoise + self.tvad:
            self.windows_passed = 0
            self.state_active = True
        else:
            self.state_active = False
            self.windows_passed += 1

        emean = float(np.abs(self._ehist).mean())
        if self.state_silence and e > emean + self.tchange:
            self.state_silence = False
            self.enoise = emean
            self._ehist = np.full(self.ehist_len, emean)
        elif (not self.state_silence
              and (e < emean - self.tchange
                   or self.windows_passed > self.windows_passed_threshold)):
            self.windows_passed = 0
            self.state_silence = True
            self._ehist = np.full(self.ehist_len, self.enoise)
        else:
            self._ehist[self._ehist_i] = e
            self._ehist_i = (self._ehist_i + 1) % self.ehist_len
        return self.state_active

    def run(self, stream, hop: int) -> np.ndarray:
        """(S,) stream -> per-window activity flags (S//hop,)."""
        s = np.asarray(stream)
        t = len(s) // hop
        return np.array([self.step(s[i * hop:(i + 1) * hop])
                         for i in range(t)], dtype=bool)
