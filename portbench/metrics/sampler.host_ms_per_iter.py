"""Host milliseconds of a traced iteration: the mean length of the
program's ``gmrm.iteration`` span (its own host clock), the time the host
takes to queue an iteration, against ``device_busy_ms_per_iter``."""

from pbcore import program


def read(run):
    it = program.spans(run).get("iteration")
    return None if it is None else it["host_ms"]
