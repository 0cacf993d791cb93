"""Milliseconds a traced iteration kept the device busy: the union of the
intervals of its kernels, copies and sets, over the traced iterations."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 1e3 * tr["busy_s"] / tr["iterations"]
