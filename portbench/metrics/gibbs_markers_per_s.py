"""Markers swept a second: Mt on this card times the iterations the
window completed, over the window's wall time (host clock, from its start
to the synchronized end of its last iteration, records included)."""


def read(run):
    return run["markers"] * run["iterations"] / run["window_s"]
