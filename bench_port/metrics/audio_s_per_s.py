"""Seconds of audio (each clip's own length, padding excluded) in all
batches of the measured window, over its wall time, first issue to the
final synchronize."""


def read(run):
    w = run.window
    return sum(run.audio_s[i] for i in w.issued) / w.seconds if w.seconds else None
