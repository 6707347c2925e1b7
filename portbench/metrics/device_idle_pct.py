"""Share of the traced span in which no kernel, copy or memset ran on the
device (torch.profiler)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or not tr["n_device_events"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
