"""Seconds of ``runner.load_data``: the .bed through the host reader, the
phenotype and group files, the interleave and padding.  Only where the
cell reads files."""


def read(run):
    return run["spans"].get("load_data")
