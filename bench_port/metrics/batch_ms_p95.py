"""The 95th percentile, over every batch of the measured window, of the
stream time between the CUDA events recorded before its first call and
after its last."""

import numpy as np


def read(run):
    return float(np.percentile(run.window.batch_ms, 95)) if run.window.batch_ms else None
