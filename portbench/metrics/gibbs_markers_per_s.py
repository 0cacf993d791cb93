"""Markers swept a second: the cell's Mt (on a cell of several cards the
whole deployment's, every card's share together) times the iterations the
window completed, over the window's wall time (host clock, from its start
to the synchronized end of its last iteration, records included; on
several cards process 0's, every process running the same iterations)."""


def read(run):
    return run["markers"] * run["iterations"] / run["window_s"]
