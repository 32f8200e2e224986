"""Hours of audio in the calls completed in the window, over the window's
wall time (it ends when the last call's results are finished)."""


def read(run):
    done = sum(1 for _, _, ok in run.calls if ok)
    return done * run.audio_s / 3600.0 / run.window_s
