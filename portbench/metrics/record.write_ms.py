"""Mean host milliseconds of the program's ``gmrm.record.write`` span in
the traced window: ``OutputSet.write_thinned``'s .csv, .bet and .cpn
writes."""

from pbcore import program


def read(run):
    s = program.spans(run).get("record.write")
    return None if s is None else s["host_ms"]
