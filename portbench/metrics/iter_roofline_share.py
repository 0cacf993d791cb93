"""The least time of one iteration's required work (portbench/work) over
the device's busy time an iteration, in percent."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * run["work"]["least_s"] / (tr["busy_s"] / tr["iterations"])
