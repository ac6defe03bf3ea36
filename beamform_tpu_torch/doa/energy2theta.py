"""Gradient-based DOA refinement from beamformer output energy.

Replicates the reference's closed-loop steering refiners:

* scripts/energy2theta.py — gradient ASCENT on the beamformed output's
  energy: a 50-window deque, energy = histogram expected value with
  Freedman-Diaconis bins frozen at the first estimate, theta += mu * dE,
  wrapped to +-180 (energy2theta.py:12-103); windows below ``vad_threshold``
  rms are skipped.
* scripts/energy2theta-diff.py — gradient DESCENT on the energy of
  (reference - beamformed), energy = plain rms over the deque
  (energy2theta-diff.py:60-107); the deque always advances, the update only
  runs on loud-enough windows.
* scripts/energy2theta-spec.py — the experimental objectives on the same
  (reference - beamformed) pairs: thresholded-spectrogram energy and
  history-normalized energy (see ``SpecGradientDoa``).

These run host-side (they are rospy leaf nodes in the reference) and feed a
theta timeline back into the models — the closed loop of SURVEY.md §1 L5.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def rms(x) -> float:
    x = np.asarray(x, dtype=np.float64)
    return float(np.sqrt(np.mean(x ** 2)))


@dataclass
class GradientDoa:
    """energy2theta.py: histogram-expected-value energy, gradient ascent."""

    theta: float = 0.0
    mu: float = 25.0
    num_win: int = 50
    vad_threshold: float = 0.001
    # "hist": Freedman-Diaconis histogram expected value (energy2theta.py's
    #         active objective);
    # "rms":  plain deque rms (the active objective of energy2theta-diff.py
    #         and one of energy2theta-spec.py's variants);
    # "spec": spectrogram magnitude mean (energy2theta-spec.py's
    #         spectrogram-energy experiment, scripts/energy2theta-spec.py)
    energy_mode: str = "hist"
    sign: float = +1.0          # ascent

    _windows: deque = field(default_factory=deque)
    _past_energy: float = -100.0
    _hist_bins: Optional[np.ndarray] = None

    def _deque_energy(self) -> float:
        data = np.abs(np.concatenate([np.asarray(w).ravel()
                                      for w in self._windows]))
        if self.energy_mode == "rms":
            return float(np.sqrt(np.mean(data ** 2)))
        if self.energy_mode == "spec":
            n = min(512, len(data))
            frames = data[:len(data) // n * n].reshape(-1, n)
            return float(np.abs(np.fft.rfft(frames, axis=-1)).mean())
        if self._hist_bins is None:
            vals, bins = np.histogram(data, "fd")
            self._hist_bins = bins
        else:
            vals, bins = np.histogram(data, self._hist_bins)
        p = vals.astype(np.float64) / data.size
        return float(np.sum(bins[:-1] * p))   # expected value

    def step(self, window) -> float:
        """Feed one beamformer output window; returns current theta."""
        w = np.asarray(window, dtype=np.float64)
        if rms(w) < self.vad_threshold:
            return self.theta
        if len(self._windows) < self.num_win:
            self._windows.append(w)
            return self.theta
        self._windows.popleft()
        self._windows.append(w)
        if self._past_energy == -100.0:
            self._past_energy = self._deque_energy()
        energy = self._deque_energy()
        theta = self.theta + self.sign * self.mu * (energy
                                                    - self._past_energy)
        if theta > 180.0:
            theta -= 360.0
        elif theta < -180.0:
            theta += 360.0
        self._past_energy = energy
        self.theta = theta
        return self.theta

    def run(self, stream, hop: int) -> np.ndarray:
        """(S,) output stream -> per-window theta timeline."""
        s = np.asarray(stream)
        t = len(s) // hop
        return np.array([self.step(s[i * hop:(i + 1) * hop])
                         for i in range(t)])


@dataclass
class DiffGradientDoa:
    """energy2theta-diff.py: descent on rms energy of (ref - beamformed)."""

    theta: float = 0.0
    mu: float = 25.0
    num_win: int = 50
    vad_threshold: float = 0.001

    _windows: deque = field(default_factory=deque)
    _past_energy: float = -100.0

    def step(self, beamformed, reference) -> float:
        diff = (np.asarray(reference, dtype=np.float64)
                - np.asarray(beamformed, dtype=np.float64))
        if len(self._windows) < self.num_win:
            self._windows.append(diff)
        else:
            self._windows.popleft()
            self._windows.append(diff)
        if rms(diff) < self.vad_threshold:
            return self.theta
        data = np.abs(np.concatenate([w.ravel() for w in self._windows]))
        energy = float(np.sqrt(np.mean(data ** 2)))
        if self._past_energy == -100.0:
            self._past_energy = energy
        theta = self.theta - self.mu * (energy - self._past_energy)
        if theta > 180.0:
            theta -= 360.0
        elif theta < -180.0:
            theta += 360.0
        self._past_energy = energy
        self.theta = theta
        return self.theta

    def run(self, beamformed, reference, hop: int) -> np.ndarray:
        b = np.asarray(beamformed)
        r = np.asarray(reference)
        t = min(len(b), len(r)) // hop
        return np.array([
            self.step(b[i * hop:(i + 1) * hop], r[i * hop:(i + 1) * hop])
            for i in range(t)])


@dataclass
class SpecGradientDoa:
    """energy2theta-spec.py: experimental objectives on (ref - beamformed).

    Two selectable objectives over a ``num_win``-deep deque of difference
    windows (energy2theta-spec.py:36-104):

    * ``"history"`` (the script's active setting, energy2theta-spec.py:18):
      per-window rms values, delta = newest - deque mean, energy =
      newest / (delta * alpha) with alpha=1000, mu=10 — normalizes the
      objective by its own recent history to "constant-ify" the search
      space (energy2theta-spec.py:78-99).
    * ``"spectrogram"``: scipy spectrogram of the concatenated deque
      (nperseg=1024, noverlap=512, scaling='spectrum'), energy = sqrt of
      the mean of bins above ``fft_threshold``, mu=5000
      (energy2theta-spec.py:55-77).

    Quirks reproduced: the theta update is ``theta += mu * (E - E_prev)``
    even though the adjacent comment reads "gradient descent (the minus
    sign is important)" — the sign in the code is '+'
    (energy2theta-spec.py:138); NaN energies become -100 ("invalid") and
    skip the update (energy2theta-spec.py:98-103,137); the deque advances
    before the VAD gate, so quiet windows still enter the objective
    (energy2theta-spec.py:127-131).
    """

    theta: float = 0.0
    num_win: int = 100
    vad_threshold: float = 0.001
    fft_threshold: float = 0.00001
    sample_rate: int = 48000
    energy_calc_method: str = "history"
    alpha: float = 1000.0
    #: optional live monitor (doa.monitor.SpecDoaMonitor): receives the
    #: (rms, delta, energy) triple of every "history" objective evaluation,
    #: the three scatter series of energy2theta-spec.py:91-95.
    monitor: object = None

    _windows: deque = field(default_factory=deque)
    _past_energy: float = -100.0

    @property
    def mu(self) -> float:
        # the script rebinds mu inside the objective (energy2theta-spec.py:
        # 61, 83): 5000 for the spectrogram objective, 10 for history
        return 5000.0 if self.energy_calc_method == "spectrogram" else 10.0

    def _deque_energy(self) -> float:
        if self.energy_calc_method == "spectrogram":
            from scipy import signal
            data = np.concatenate([np.asarray(w).ravel()
                                   for w in self._windows])
            _, _, spec = signal.spectrogram(
                data, self.sample_rate, nperseg=1024, noverlap=512,
                scaling="spectrum")
            filt = spec[spec > self.fft_threshold]
            with np.errstate(invalid="ignore"):
                energy = (float(np.sqrt(np.mean(filt)))
                          if filt.size else float("nan"))
        elif self.energy_calc_method == "history":
            past = np.array([rms(w) for w in self._windows])
            delta = past[-1] - past.mean()
            with np.errstate(divide="ignore", invalid="ignore"):
                energy = float(past[-1] / (delta * self.alpha))
            if self.monitor is not None:
                # the reference scatters the raw (possibly non-finite)
                # energy before its NaN guard (energy2theta-spec.py:91-98)
                self.monitor.update(float(past[-1]), float(delta), energy)
        else:
            energy = -100.0
        if np.isnan(energy):
            energy = -100.0
        return energy

    def step(self, beamformed, reference) -> float:
        diff = (np.asarray(reference, dtype=np.float64)
                - np.asarray(beamformed, dtype=np.float64))
        if len(self._windows) < self.num_win:
            self._windows.append(diff)
            return self.theta
        self._windows.popleft()
        self._windows.append(diff)
        if rms(diff) < self.vad_threshold:
            return self.theta
        if self._past_energy == -100.0:
            self._past_energy = self._deque_energy()
        energy = self._deque_energy()
        if energy > -100.0:
            theta = self.theta + self.mu * (energy - self._past_energy)
            if theta > 180.0:
                theta -= 360.0
            elif theta < -180.0:
                theta += 360.0
            self._past_energy = energy
            self.theta = theta
        return self.theta

    def run(self, beamformed, reference, hop: int) -> np.ndarray:
        b = np.asarray(beamformed)
        r = np.asarray(reference)
        t = min(len(b), len(r)) // hop
        return np.array([
            self.step(b[i * hop:(i + 1) * hop], r[i * hop:(i + 1) * hop])
            for i in range(t)])
