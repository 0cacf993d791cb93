"""The share of the traced window's wall time in which no kernel, copy or
set ran on the device, in percent."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
