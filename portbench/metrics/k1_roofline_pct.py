"""K1 (prune_fwd_bwd) against its HBM roofline: the least bytes of the
traced span's K1 work (portbench/roofline.k1_bytes over the valid frames
of the batches dispatched in it) at 3.35 TB/s, over the profiled device
time of every K1 launch."""

from portbench import roofline


def read(rec):
    tr = rec.get("trace")
    if not tr or not rec.get("k1_bytes"):
        return None
    t = sum(v for k, v in tr["kernel_s"].items()
            if "prune_fwd_bwd" in k)
    return roofline.share_pct(rec["k1_bytes"], t)
