"""K1f (prune_fwd_carry, the streamed route's forward prune with its
envelope carry) against its HBM roofline: the least bytes of the traced
span's K1f launches (portbench/roofline_k1f over each launch's valid
frames) at 3.35 TB/s, over the profiled device time of every K1f launch.
Each launch is a serial chain over a chunk's frames, so the share reads
well under 1 %."""

from portbench import roofline


def read(rec):
    tr = rec.get("trace")
    if not tr or not rec.get("k1f_bytes"):
        return None
    t = sum(v for k, v in tr["kernel_s"].items() if "prune_fwd_carry" in k)
    return roofline.share_pct(rec["k1f_bytes"], t)
