"""Context of ``serve.paged.prefill_round`` (one admission chunk round):
each row's start and number of prompt tokens, for the attention counter
of the layers inside it."""

import numpy as np


def before(rec, call):
    a = call.args
    rec.round = (np.asarray(a[4]).tolist(), np.asarray(a[5]).tolist())


def count(rec, call):
    rec.round = None
