"""End-to-end demo of the PyTorch/CUDA port: synthesize a two-source
scene, run every beamformer, report separation metrics, and write WAVs.

    python examples/torch_demo.py [--outdir DIR] [--cpu] [--seconds S]

The port's counterpart of ``examples/demo.py``: the same scene (a target
at 0 degrees, an interferer at 90 on a 4-mic array, 48 kHz, hop 512), the
same eight nodes and parameters, the same SIR table and WAVs. It runs on
the CUDA card unless ``--cpu`` asks for the CPU, and needs no install: it
puts the repository root on ``sys.path`` itself.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


FS, HOP = 48000, 512
ARRAY = [(0.0, 0.0), (0.0, -0.5), (-0.45, -0.25), (0.3, 0.4)]
#: the nodes and their parameters, as examples/demo.py runs them
PARAMS = {
    "das": {}, "phase": dict(min_phase=40.0, mag_threshold=0.0),
    "mvdr": dict(freq_mag_threshold=1e-4, freq_max=16000, freq_min=100,
                 out_amp=1.0),
    "lcmv": dict(freq_mag_threshold=1e-4, freq_max=16000, freq_min=100,
                 out_amp=1.0),
    "gss": dict(freq_mag_threshold=1e-4, freq_max=16000, freq_min=100,
                out_amp=1.0, mu=0.001),
    "gsc": dict(mu0=0.0001, mu_max=0.1, filter_size=128),
    "phasempf": dict(min_phase=30.0, min_mag=0.05, smooth_size=3,
                     MCRA_L=50, out_amp=1.0),
    "mcra": dict(L=50, out_amp=1.0),
}


def demo_scene(seconds: float, dtype: str = "float32"):
    """(engine, array config, scene): the target at 0 degrees, the
    interferer at 90 (the array config's static interference set), each a
    low-passed noise source with a quiet lead-in, seed 0."""
    from beamform_tpu_torch.config import EngineConfig, parse_array_config
    from beamform_tpu_torch.evaluation import synth_scene
    from beamform_tpu_torch.geometry import ArrayGeometry

    cfg = parse_array_config(
        {f"mic{i}": {"id": i, "x": x, "y": y}
         for i, (x, y) in enumerate(ARRAY)} | {"angle_interf1": 90.0})
    engine = EngineConfig(sample_rate=FS, window_size=HOP, dtype=dtype)
    rng = np.random.default_rng(0)
    s = int(FS * seconds) // HOP * HOP
    k = np.hanning(16)
    k /= k.sum()

    def src(seed):
        sig = np.convolve(rng.standard_normal(s) * 0.25, k, "same")
        sig[:12 * HOP] *= 1e-4   # quiet lead-in for the covariance models
        return sig

    scene = synth_scene(ArrayGeometry.from_config(cfg), [src(1), src(2)],
                        [0.0, 90.0], FS, noise_std=0.001)
    return engine, cfg, scene


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "beamform_demo"))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from beamform_tpu_torch.evaluation import (align_to_ref,
                                               evaluate_separation)
    from beamform_tpu_torch.models import get_model
    from beamform_tpu_torch.runtime import wav as wav_io

    engine, cfg, scene = demo_scene(args.seconds)
    os.makedirs(args.outdir, exist_ok=True)
    wav_io.write_wav(f"{args.outdir}/mixture.wav", scene.mixture, FS,
                     fmt="float32")
    table = {}
    for name, p in PARAMS.items():
        model = get_model(name, engine, cfg, p, device=device)
        rep = evaluate_separation(model, scene, theta=0.0)
        y = align_to_ref(model.process(scene.mixture, 0.0).cpu().numpy(),
                         HOP)
        wav_io.write_wav(f"{args.outdir}/{name}.wav",
                         np.nan_to_num(y), FS, fmt="float32")
        table[name] = rep
        print(f"{name:9s} SIR {rep['sir_in_db']:6.2f} -> "
              f"{rep['sir_out_db']:6.2f} dB  (gain {rep['sir_gain_db']:+.2f})")
    with open(f"{args.outdir}/report.json", "w") as f:
        json.dump(table, f, indent=2)
    print(f"\nWAVs + report.json in {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
