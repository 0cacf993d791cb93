"""Launches and graph replays the host issued in the traced window
(runtime calls cudaLaunch*, cuLaunch*, cudaGraphLaunch) per iteration."""


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    return tr["launches"] / tr["iterations"]
