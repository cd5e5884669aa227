"""Wall ms from a ``train.chunk`` span's start to the end of its first
``train.replay``, mean over the traced chunks: the host's time before the
card has a chunk's first step (the index upload, the first draws and
launch), in which the card waits.  ``train.upload`` and ``train.draw``
under it say which part."""

from perfcells import spans as sp

UNIT = "ms"


def read(ctx):
    s = sp.program_spans()
    heads = {}
    for x in sp.closed(s, "train.replay"):
        chunk = x.parent
        while chunk is not None and s[chunk].name != "train.chunk":
            chunk = s[chunk].parent
        if chunk is not None and chunk not in heads:
            heads[chunk] = (x.end_ns - s[chunk].start_ns) * 1e-6
    return sum(heads.values()) / len(heads) if heads else None
