"""Counter of the callable ``models.llama._slot_attend`` returns (a
layer's prefill attention over the scratch cache): causal operations of
the round's chunks (``prefill_round``'s starts and takes)."""

from bench_port import roofline


def count(rec, call):
    if rec.round is None:
        return
    q, k = call.args[0], call.args[1]
    starts, takes = rec.round
    cache = call.outer[0]
    ops, nbytes = roofline.causal_prefill_attention(
        starts, takes, q.shape[2], k.shape[2], q.shape[3],
        cache.k.element_size(), q.element_size())
    rec.add("attn", ops, nbytes)
