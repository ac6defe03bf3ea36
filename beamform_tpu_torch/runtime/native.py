"""ctypes bindings for the native audio runtime (``csrc/beamio.cpp``).

The library holds the host side of the live runtimes: the SPSC ring
buffer (the jack_ringbuffer role), the streaming sinc resampler (the
libsamplerate role), chunked WAV reading, an ALSA PCM and a client in a
JACK graph. ALSA and JACK are bound at run time with ``dlopen``, so the
library builds without their development files, and a host without them
gets the reference's error when a PCM or a client is opened
(``BEAMIO_JACK_LIB`` overrides libjack's path: the hook a fake server
stands in through).

The library is built from the repository's ``csrc/beamio.cpp`` with
``g++`` at first use, into ``beamform_tpu_torch/kernels/build/`` under a
name keyed by a hash of the source, the flags, the compiler and the CPU
that ``-march=native`` resolves to; it is written under a temporary name
and renamed atomically, so parallel processes never load a half-written
file, and nothing is written into ``csrc/``. A failed build raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from typing import Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_ROOT, "csrc")
BUILD_DIR = os.path.join(_ROOT, "beamform_tpu_torch", "kernels", "build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lm", "-ldl")


def _native_target() -> bytes:
    """What ``-march=native`` means on this host, by the compiler's own
    account: a library built on another CPU must not be loaded here."""
    return b"".join(
        subprocess.run(["g++", *flags], capture_output=True,
                       timeout=60).stdout
        for flags in (["--version"], ["-march=native", "-Q",
                                      "--help=target"]))


@functools.cache
def build_library(source: str) -> str:
    """Compile ``csrc/<source>`` into the build directory (once per source
    and host); returns the shared library's path."""
    src = os.path.join(CSRC, source)
    with open(src, "rb") as f:
        code = f.read()
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode() + b"\0" + code
                       + b"\0" + _native_target())
    stem = os.path.splitext(source)[0]
    path = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, src, *LIBS],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"g++ failed to build {src} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    return path


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load ``libbeamio``, once per process."""
    lib = ctypes.CDLL(build_library("beamio.cpp"))
    c = ctypes
    lib.bio_wav_stream_open.restype = c.c_void_p
    lib.bio_wav_stream_open.argtypes = [c.c_char_p, c.POINTER(c.c_int),
                                        c.POINTER(c.c_int),
                                        c.POINTER(c.c_long)]
    lib.bio_wav_stream_read.restype = c.c_long
    lib.bio_wav_stream_read.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                        c.c_long]
    lib.bio_wav_stream_close.argtypes = [c.c_void_p]
    lib.bio_ring_create.restype = c.c_void_p
    lib.bio_ring_create.argtypes = [c.c_long]
    lib.bio_ring_write.restype = c.c_long
    lib.bio_ring_write.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                   c.c_long]
    lib.bio_ring_read.restype = c.c_long
    lib.bio_ring_read.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_long]
    lib.bio_ring_available.restype = c.c_long
    lib.bio_ring_available.argtypes = [c.c_void_p]
    lib.bio_ring_free.argtypes = [c.c_void_p]
    lib.bio_src_new.restype = c.c_void_p
    lib.bio_src_new.argtypes = [c.c_int, c.c_int, c.c_int]
    lib.bio_src_process.restype = c.c_long
    lib.bio_src_process.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                    c.c_long, c.POINTER(c.c_float), c.c_long]
    lib.bio_src_free.argtypes = [c.c_void_p]
    lib.bio_alsa_open.restype = c.c_void_p
    lib.bio_alsa_open.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_int,
                                  c.c_int, c.c_char_p, c.c_int]
    lib.bio_alsa_read.restype = c.c_long
    lib.bio_alsa_read.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_long]
    lib.bio_alsa_write.restype = c.c_long
    lib.bio_alsa_write.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                   c.c_long]
    lib.bio_alsa_xruns.restype = c.c_long
    lib.bio_alsa_xruns.argtypes = [c.c_void_p]
    lib.bio_alsa_close.argtypes = [c.c_void_p]
    lib.bio_jack_runtime_available.restype = c.c_int
    lib.bio_jack_open.restype = c.c_void_p
    lib.bio_jack_open.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_int,
                                  c.POINTER(c.c_int), c.POINTER(c.c_int),
                                  c.POINTER(c.c_int), c.POINTER(c.c_int),
                                  c.c_char_p, c.c_int]
    lib.bio_jack_read.restype = c.c_long
    lib.bio_jack_read.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_long]
    lib.bio_jack_write.restype = c.c_long
    lib.bio_jack_write.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                   c.c_long]
    lib.bio_jack_xruns.restype = c.c_long
    lib.bio_jack_xruns.argtypes = [c.c_void_p]
    lib.bio_jack_alive.restype = c.c_int
    lib.bio_jack_alive.argtypes = [c.c_void_p]
    lib.bio_jack_close.argtypes = [c.c_void_p]
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class RingBuffer:
    """Lock-free SPSC ring buffer (the jack_ringbuffer role)."""

    def __init__(self, capacity: int):
        self._lib = load()
        self._h = self._lib.bio_ring_create(capacity)

    def write(self, data) -> int:
        x = np.ascontiguousarray(data, dtype=np.float32)
        return self._lib.bio_ring_write(self._h, _fp(x), x.size)

    def read(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float32)
        got = self._lib.bio_ring_read(self._h, _fp(out), n)
        return out[:got]

    @property
    def available(self) -> int:
        return self._lib.bio_ring_available(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bio_ring_free(self._h)
            self._h = None


class Resampler:
    """Streaming polyphase sinc resampler (the libsamplerate role)."""

    def __init__(self, fs_in: int, fs_out: int, taps_per_phase: int = 16):
        self._lib = load()
        self._h = self._lib.bio_src_new(fs_in, fs_out, taps_per_phase)
        self.ratio = fs_out / fs_in

    def process(self, block) -> np.ndarray:
        x = np.ascontiguousarray(block, dtype=np.float32)
        max_out = int(np.ceil(x.size * self.ratio)) + 64
        out = np.empty(max_out, dtype=np.float32)
        got = self._lib.bio_src_process(self._h, _fp(x), x.size, _fp(out),
                                        max_out)
        return out[:got]

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bio_src_free(self._h)
            self._h = None


class WavStream:
    """Chunked WAV reader: feeds fixed-size hops without loading the file."""

    def __init__(self, path: str):
        self._lib = load()
        ch, fs, fr = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
        self._h = self._lib.bio_wav_stream_open(
            path.encode(), ctypes.byref(ch), ctypes.byref(fs),
            ctypes.byref(fr))
        if not self._h:
            raise IOError(f"cannot open {path}")
        self.channels, self.sample_rate, self.frames = (ch.value, fs.value,
                                                        fr.value)

    def read(self, frames: int) -> Tuple[np.ndarray, int]:
        """Returns ((C, frames) float32 zero-padded at EOF, frames_read)."""
        out = np.empty((frames, self.channels), dtype=np.float32)
        got = self._lib.bio_wav_stream_read(self._h, _fp(out), frames)
        if got < 0:
            raise IOError("stream read failed")
        return np.ascontiguousarray(out.T), int(got)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.bio_wav_stream_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class JackClient:
    """A client in an existing JACK graph: the literal rosjack role
    (rosjack.cpp:98-157 client + input_N/output ports + RT callback,
    :234-270 physical-port auto-connect). The process callback runs on the
    server's real-time thread and exchanges samples with this object
    through lock-free SPSC rings; read/write here block with backpressure.

    Raises RuntimeError with the underlying reason when no JACK runtime or
    server exists."""

    def __init__(self, name: str = "beamform_tpu", *, channels: int,
                 auto_connect: bool = True, connect_out: bool = True):
        self._lib = load()
        self._h = None
        c = ctypes
        sr, bs = c.c_int(), c.c_int()
        cin, cout = c.c_int(), c.c_int()
        err = c.create_string_buffer(256)
        self._h = self._lib.bio_jack_open(
            name.encode(), channels, int(auto_connect), int(connect_out),
            c.byref(sr), c.byref(bs), c.byref(cin), c.byref(cout),
            err, len(err))
        if not self._h:
            raise RuntimeError(
                f"JACK open({name!r}) failed: "
                f"{err.value.decode(errors='replace')}")
        self.channels = channels
        self.sample_rate = sr.value      # engine runs at the server rate,
        self.buffer_size = bs.value      # exactly rosjack.cpp:141-145
        self.connected_in = cin.value
        self.connected_out = cout.value

    def read(self, frames: int) -> np.ndarray:
        """Blocking capture of (channels, frames) float32 from the graph.

        Raises RuntimeError when the server shut down or stalled >5 s
        (short read)."""
        out = np.empty((frames, self.channels), dtype=np.float32)
        got = self._lib.bio_jack_read(self._h, _fp(out), frames)
        if got < frames:
            raise RuntimeError(
                "JACK capture stalled or server shut down "
                f"(got {got}/{frames} frames; alive={self.alive})")
        return np.ascontiguousarray(out.T)

    def write(self, data) -> int:
        """Blocking mono playback into the graph's output port."""
        x = np.ascontiguousarray(np.asarray(data, dtype=np.float32).ravel())
        return int(self._lib.bio_jack_write(self._h, _fp(x), x.size))

    @property
    def xruns(self) -> int:
        return int(self._lib.bio_jack_xruns(self._h))

    @property
    def alive(self) -> bool:
        return bool(self._lib.bio_jack_alive(self._h))

    def close(self):
        if getattr(self, "_h", None):
            self._lib.bio_jack_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class AlsaPcm:
    """One ALSA PCM direction: the in-process audio-device role of the
    reference's JACK client (rosjack.cpp:102-157 client+ports, :234-270
    auto-connect). Interleaved float32 at the engine rate; xruns recovered
    and counted like jack_xrun_callback (rosjack.cpp:78-82).

    Raises RuntimeError with the underlying reason when no sound stack or
    device exists."""

    def __init__(self, device: str = "default", *, capture: bool,
                 channels: int, rate: int, latency_us: int = 100_000):
        self._lib = load()
        self._h = None
        err = ctypes.create_string_buffer(256)
        self._h = self._lib.bio_alsa_open(
            device.encode(), int(capture), channels, rate, latency_us,
            err, len(err))
        if not self._h:
            raise RuntimeError(
                f"ALSA open({device!r}, capture={capture}) failed: "
                f"{err.value.decode(errors='replace')}")
        self.channels = channels
        self.capture = capture

    def read(self, frames: int) -> np.ndarray:
        """Blocking capture of (channels, frames) float32.

        Raises RuntimeError when the device returns nothing at all (e.g.
        unplugged -> ENODEV after snd_pcm_recover fails): silently
        zero-filling there would make the live loop busy-spin on silence
        forever with no diagnostic. A short-but-nonzero read (mid-recover
        xrun) is still zero-padded — that is a glitch, not a dead device."""
        out = np.empty((frames, self.channels), dtype=np.float32)
        got = self._lib.bio_alsa_read(self._h, _fp(out), frames)
        if got <= 0 and frames > 0:
            raise RuntimeError(
                "ALSA capture returned no frames (device removed or "
                f"unrecoverable PCM error; xruns so far: {self.xruns})")
        if got < frames:
            out[got:] = 0.0
        return np.ascontiguousarray(out.T)

    def write(self, data) -> int:
        """Blocking playback of (channels, frames) or (frames,) float32."""
        x = np.asarray(data, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        inter = np.ascontiguousarray(x.T)
        return int(self._lib.bio_alsa_write(self._h, _fp(inter), x.shape[1]))

    @property
    def xruns(self) -> int:
        return int(self._lib.bio_alsa_xruns(self._h))

    def close(self):
        if getattr(self, "_h", None):
            self._lib.bio_alsa_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
