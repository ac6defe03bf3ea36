"""Configuration layer (jax-free copy of ``beamform_tpu.config``'s subset
that the ported slice needs).

Reads the reference package's YAML schemas (``beamform_config.yaml`` and
``rosjack_config.yaml``) and the per-node launch presets, with the same
reference semantics as the JAX package:

* mic geometry is given as ``micN: {id, x, y[, z]}`` keys, parsed for
  consecutive N starting at 0 (``util.h:75-92``); ``z`` is ignored.
* polar coordinates (``dist``, ``angle``) are computed from the RAW x/y
  before re-referencing to mic0 (``util.h:83-84``); ``rereference_polar``
  opts into recomputing them after re-referencing.
* interference slots ``angle_interf1..`` are parsed until a value with
  ``abs(angle) > 180`` (sentinel 181.0) is found (``util.h:94-113``).

Only the ported nodes (``das``, ``mvdr``, ``lcmv``, ``gss``, ``gsc``,
``phase``, ``mcra``, ``phasempf``) have parameter classes so far; the
other nodes' classes arrive with their models (ROADMAP.md §1).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import yaml

log = logging.getLogger("beamform_tpu_torch.config")

# Output-type policy (rosjack.h:28-31).
ROSJACK_OUT_BOTH = 0
ROSJACK_OUT_JACK = 1
ROSJACK_OUT_ROS = 2


@dataclass(frozen=True)
class MicSpec:
    """One microphone entry from the config (util.h:75-92)."""

    id: int
    x: float
    y: float
    # polar coordinates from the coordinates as written in the YAML, before
    # mic0 re-referencing (util.h:83-84)
    dist: float = 0.0
    angle_deg: float = 0.0


@dataclass(frozen=True)
class ArrayConfig:
    """Parsed ``beamform_config.yaml``."""

    verbose: bool = False
    initial_angle: float = 0.0
    mics: tuple = ()
    interference_angles: tuple = ()
    rereference_polar: bool = False

    @property
    def num_mics(self) -> int:
        return len(self.mics)


@dataclass(frozen=True)
class RosjackConfig:
    """Parsed ``rosjack_config.yaml`` (rosjack.cpp:6-72)."""

    output_type: int = ROSJACK_OUT_BOTH
    auto_connect: bool = True
    write_file: bool = False
    write_file_path: str = ""
    write_xrun: bool = False
    ros_output_sample_rate: Optional[int] = None  # None => engine rate


def _mic_from_mapping(idx: int, m: Dict[str, Any], rereference_polar: bool,
                      ref_xy=(0.0, 0.0)) -> MicSpec:
    x = float(m.get("x", 0.0))
    y = float(m.get("y", 0.0))
    if rereference_polar:
        px, py = x - ref_xy[0], y - ref_xy[1]
    else:
        px, py = x, y
    return MicSpec(
        id=int(m.get("id", idx)),
        x=x,
        y=y,
        dist=math.hypot(px, py),
        angle_deg=math.degrees(math.atan2(py, px)),
    )


def parse_array_config(doc: Dict[str, Any], *,
                       rereference_polar: bool = False) -> ArrayConfig:
    """Build an :class:`ArrayConfig` from a loaded YAML mapping
    (``handle_params``, util.h:52-134)."""
    doc = doc or {}
    mics: List[MicSpec] = []
    i = 0
    ref_xy = (0.0, 0.0)
    while f"mic{i}" in doc:
        m = doc[f"mic{i}"]
        if i == 0:
            ref_xy = (float(m.get("x", 0.0)), float(m.get("y", 0.0)))
        mics.append(_mic_from_mapping(i, m, rereference_polar, ref_xy))
        i += 1

    interf: List[float] = []
    k = 1
    while f"angle_interf{k}" in doc:
        a = float(doc[f"angle_interf{k}"])
        if abs(a) > 180.0:
            break
        interf.append(a)
        k += 1

    return ArrayConfig(
        verbose=bool(doc.get("verbose", False)),
        initial_angle=float(doc.get("initial_angle", 0.0)),
        mics=tuple(mics),
        interference_angles=tuple(interf),
        rereference_polar=rereference_polar,
    )


def load_array_config(path: str, **kw) -> ArrayConfig:
    with open(path) as f:
        return parse_array_config(yaml.safe_load(f), **kw)


def parse_rosjack_config(doc: Dict[str, Any]) -> RosjackConfig:
    doc = doc or {}
    out_type = int(doc.get("output_type", ROSJACK_OUT_BOTH))
    if out_type not in (ROSJACK_OUT_BOTH, ROSJACK_OUT_JACK, ROSJACK_OUT_ROS):
        out_type = ROSJACK_OUT_BOTH  # rosjack.cpp:17-19 warn-and-default
    sr = doc.get("ros_output_sample_rate", None)
    return RosjackConfig(
        output_type=out_type,
        auto_connect=bool(doc.get("auto_connect", True)),
        write_file=bool(doc.get("write_file", False)),
        write_file_path=str(doc.get("write_file_path", "") or ""),
        write_xrun=bool(doc.get("write_xrun", False)),
        ros_output_sample_rate=int(sr) if sr is not None else None,
    )


def load_rosjack_config(path: str) -> RosjackConfig:
    with open(path) as f:
        return parse_rosjack_config(yaml.safe_load(f))


@dataclass(frozen=True)
class DasParams:
    """das.cpp has no extra parameters."""


@dataclass(frozen=True)
class MvdrParams:
    """mvdr.cpp:146-187 defaults."""

    past_windows: int = 10
    freq_mag_threshold: float = 1.5
    freq_max: float = 4000.0
    freq_min: float = 400.0
    out_amp: float = 4.5
    # implementation strategy, not a reference param (models/mvdr.py
    # select_solver_strategy): "auto" runs the CUDA streaming solve kernel
    # on a CUDA float32 engine within its capacity and the dense block
    # pipeline elsewhere; "stream" forces the streaming solve (its plain
    # version on the CPU), "dense" the block pipeline (the Gauss-Jordan
    # kernel on CUDA); "sparse" is the deprecated float64 alias of "dense";
    # "mega" the fused audio-to-audio kernel (its plain version on the CPU).
    solver: str = "auto"


@dataclass(frozen=True)
class LcmvParams:
    """lcmv.cpp:171-219 defaults."""

    past_windows: int = 10
    freq_mag_threshold: float = 1.5
    freq_max: float = 4000.0
    freq_min: float = 400.0
    out_amp: float = 4.5
    interf_angle_threshold: float = 5.0
    solver: str = "auto"          # see MvdrParams.solver


@dataclass(frozen=True)
class GssParams:
    """gss.cpp:187-240 defaults."""

    freq_mag_threshold: float = 1.5
    freq_max: float = 4000.0
    freq_min: float = 400.0
    out_amp: float = 4.5
    mu: float = 0.01
    lam: float = 0.0  # "lambda" in the reference
    interf_angle_threshold: float = 5.0
    # demixing-update strategy (models/gss.py GssModel._strategy): "auto"
    # runs the fused CUDA kernel (kernels/gss_stream.py) on a CUDA float32
    # engine and the plain march on the CPU; "mega" the fused kernel (its
    # plain version on the CPU); "scan" the plain march, on the CPU only.
    solver: str = "auto"


@dataclass(frozen=True)
class GscParams:
    """gsc.cpp:206-258 defaults."""

    use_vad: bool = False
    vad_threshold: float = 0.1
    mu0: float = 0.0005
    mu_max: float = 0.01
    filter_size: int = 128
    write_mu: bool = False
    # adaptive-stage strategy (models/gsc.py GscModel._strategy): "sample",
    # the faithful per-sample recurrence (the CUDA kernel of
    # kernels/gsc.py on a CUDA float32 engine with 128 taps, its plain
    # version on the CPU); "xmu", the same recurrence with the input-only
    # mu terms (block powers, q-branch steps) computed outside the kernel;
    # "blocklms", the NON-faithful block LMS of kernels/gsc_blocklms.py
    # (filters frozen for block_samples, updates land at block ends);
    # "block", the exact lookahead-8 factorisation of kernels/gsc_block.py
    # (its CUDA kernel on the card; on the CPU the per-sample recurrence,
    # as the JAX package runs it off the TPU)
    solver: str = "sample"
    # blocklms only: samples the filter bank stays frozen for (128, 256,
    # 512 or 1024)
    block_samples: int = 128


@dataclass(frozen=True)
class PhaseParams:
    """phase.cpp:165-191 defaults.

    The reference's launch file also passes ``min_mag`` and
    ``smooth_size``, which the node never reads (phase.cpp:177-189); like
    the ROS param server, :func:`make_params` drops them.
    """

    min_phase: float = 10.0  # degrees
    mag_mult: float = 0.1
    mag_threshold: float = 0.05
    # bfloat16 mask arithmetic on the spectra (the JAX package's
    # quantized-inference experiment); runs the batched plain formulation
    spectra_bf16: bool = False
    # mask strategy (models/phase.py PhaseModel._strategy): "auto" runs the
    # CUDA phase-mask kernel on a CUDA float32 engine and the batched plain
    # formulation elsewhere; "fused" forces the kernel's path (its plain
    # version on the CPU); "xla" forces the batched formulation
    solver: str = "auto"


@dataclass(frozen=True)
class McraParams:
    """mcra.cpp:179-231 defaults."""

    alphaS: float = 0.95
    alphaD: float = 0.95
    alphaD2: float = 0.97
    delta: float = 0.001
    L: int = 75
    out_amp: float = 2.0
    out_only_noise: bool = True  # mcra.cpp:227 default when param absent


@dataclass(frozen=True)
class PhasempfParams:
    """phasempf.cpp:355-475 defaults."""

    min_phase: float = 10.0   # degrees
    min_mag: float = 10.0     # default when absent (phasempf.cpp:370)
    smooth_size: int = 20
    MCRA_alphaS: float = 0.95
    MCRA_alphaD: float = 0.95
    MCRA_alphaD2: float = 0.97
    MCRA_delta: float = 0.001
    MCRA_L: int = 75
    MPF_alphaS: float = 0.3
    MPF_eta: float = 0.3
    MPF_rev_gamma: float = 0.3
    MPF_rev_delta: float = 1.0
    out_amp: float = 2.0      # default when absent (phasempf.cpp:451)
    noise_floor: float = 0.001
    out_only_noise: bool = False
    out_only_mcra: bool = False
    # see PhaseParams.solver: "auto" and "fused" run the dual beams and the
    # MCRA/MPF march in the CUDA MPF kernels on a CUDA float32 engine
    solver: str = "auto"


PARAM_CLASSES = {"das": DasParams, "mvdr": MvdrParams, "lcmv": LcmvParams,
                 "gss": GssParams, "gsc": GscParams, "phase": PhaseParams,
                 "mcra": McraParams, "phasempf": PhasempfParams,
                 "ref": DasParams, "read": DasParams}
# implementation knobs are not reference parameters: no warn-and-default
_IMPL_KNOBS = {"solver", "spectra_bf16", "block_samples"}


def load_launch_params(node: str, path: Optional[str] = None
                       ) -> Dict[str, Any]:
    """The per-node hyperparameters of the reference's launch files
    (launch/*.launch), shipped as configs/launch_params.yaml."""
    if path is None:
        path = os.path.join(os.path.dirname(__file__), "configs",
                            "launch_params.yaml")
    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    return dict(doc.get(node) or {})


def make_params(model: str, overrides: Optional[Dict[str, Any]] = None):
    """Instantiate a node's parameter dataclass with launch-style overrides.

    Unknown keys are ignored, as the ROS param server lets a node read only
    the keys it knows; ``lambda`` is accepted for :attr:`GssParams.lam`
    (the launch preset's name). Each known parameter is logged the way the
    reference's ``*_handle_params`` does (INFO when supplied, WARN with the
    default when absent, mvdr.cpp:150-186).
    """
    if model not in PARAM_CLASSES:
        raise NotImplementedError(
            f"node {model!r} is not ported to beamform_tpu_torch yet "
            "(see ROADMAP.md §1)")
    cls = PARAM_CLASSES[model]
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for key, val in (overrides or {}).items():
        if key == "lambda" and "lam" in fields:
            key = "lam"
        if key in fields:
            kw[key] = val
    obj = cls(**kw)
    for f in dataclasses.fields(cls):
        if f.name in _IMPL_KNOBS:
            if f.name in kw:
                log.debug("%s/%s (impl knob): %s", model, f.name, kw[f.name])
            continue
        if f.name in kw:
            log.info("%s/%s: %s", model, f.name, kw[f.name])
        else:
            log.warning(
                "%s/%s argument not found in config, using default value "
                "(%s).", model, f.name, getattr(obj, f.name))
    return obj


@dataclass(frozen=True)
class EngineConfig:
    """Global engine settings: the JACK server state plus the numerics
    policy."""

    sample_rate: int = 48000       # jack_get_sample_rate (rosjack.cpp:133)
    window_size: int = 1024        # jack_get_buffer_size (rosjack.cpp:131)
    dtype: str = "float32"         # compute dtype ("float32" | "float64")
    # faithful frequency-vector off-by-one (geometry.frequency_vector)
    exact_freqs: bool = False
    # MCRA / PhaseMPF leave the DC output bin unwritten (the out-of-bounds
    # write at mcra.cpp:127 and phasempf.cpp:274): True keeps it 0, False
    # passes X0[0] through
    bug_dc_zero: bool = True
    # audit mode: the reference's literal N-point complex FFT layout instead
    # of the extended-rFFT shadow-bin layout (CPU only in this package)
    full_fft: bool = False

    @property
    def fft_win(self) -> int:
        return 2 * self.window_size  # util.h:261

    @property
    def hop(self) -> int:
        return self.window_size
