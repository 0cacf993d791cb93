"""Seconds of ``runner.build_static`` (marker statistics, and the Gram
cache where the plan keeps one), synchronized."""


def read(run):
    return run["spans"].get("build_static")
