"""SIR-driven steering and its closed-loop test stub.

* SirToTheta — scripts/SIR2theta.py: theta -= mu * (SIR - past_SIR) on every
  SIR measurement (SIR2theta.py:7-25).
* SirDummy — scripts/SIRdummy.py: fakes SIR = -theta^2 so the controller can
  be tested without an acoustic scene (SIRdummy.py:10-12) — the reference's
  only mock; kept as the convergence smoke test.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SirToTheta:
    theta: float = 1.0
    mu: float = 0.01
    _past_sir: float = -100.0

    def step(self, sir: float) -> float:
        theta = self.theta - self.mu * (sir - self._past_sir)
        self._past_sir = sir
        self.theta = theta
        return theta


@dataclass
class SirDummy:
    def measure(self, theta: float) -> float:
        return -(theta * theta)


@dataclass
class SpeakerIdStub:
    """scripts/speakeridrest.py: placeholder speaker-id publisher that fires
    every ~10 windows (speakeridrest.py:15-41)."""

    every: int = 10
    _count: int = 0

    def step(self, window) -> str | None:
        self._count += 1
        if self._count > self.every:
            self._count = 0
            w0 = float(window[0]) if len(window) else 0.0
            return f"speaker? ({w0:.6f})"
        return None
