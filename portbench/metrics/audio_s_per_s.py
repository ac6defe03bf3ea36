"""Audio-seconds of all streams whose output reached the host in the
window, over the window's seconds (host clock): every chunk of the
window, all its work and all its time."""


def read(run):
    return run.audio_s / run.window_s
