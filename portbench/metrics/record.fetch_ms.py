"""Mean host milliseconds of the program's ``gmrm.record.fetch`` span in
the traced window: ``runner._host_record``'s copies to the host and the
markers' reorder (the harness waits for the device first)."""

from pbcore import program


def read(run):
    s = program.spans(run).get("record.fetch")
    return None if s is None else s["host_ms"]
