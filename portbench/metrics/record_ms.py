"""Mean host milliseconds of a thinned record in the window, from the
moment the iterations queued before it have finished: ``runner._host_record``
(the state's copies to the host, the markers back in their order) and
``OutputSet.write_thinned``."""


def read(run):
    xs = run["records_s"]
    if not xs:
        return None
    return 1e3 * sum(xs) / len(xs)
