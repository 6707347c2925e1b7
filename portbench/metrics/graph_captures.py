"""CUDA graphs captured inside the window (utils/graphs.counts): 0 when the
warm-up covered every key the window runs."""


def read(rec):
    return rec.get("graph_captures")
