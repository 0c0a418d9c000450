"""95th percentile of every gap between consecutive tokens of a
request, both tokens in the window (host clock at ``on_token``), ms."""

import numpy as np


def read(run):
    gaps = run.gaps_s()
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None
