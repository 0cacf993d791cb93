"""The reduction of a trace into busy time, gaps and launches."""

from pbcore import trace


def test_union_and_busy():
    merged = trace.union([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)])
    assert merged == [(0.0, 2.0), (3.0, 4.0)]
    assert trace.busy_seconds(merged, 1.0, 3.5) == 1.5
    assert trace.gaps(merged, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]


def test_reduce_names_gaps_by_the_host():
    dev = [("k1", 0.0, 1.0), ("k2", 1.0, 1.5), ("k1", 3.0, 3.25)]
    host = [("portbench.window", 0.0, 4.0), ("portbench.record", 1.5, 3.0),
            ("cudaStreamSynchronize", 1.6, 2.9), ("cudaLaunchKernel", 0.1, 0.2),
            ("cudaGraphLaunch", 2.95, 2.99)]
    r = trace.reduce(dev, host, 0.0, 4.0)
    assert r["busy_s"] == 1.75 and r["window_s"] == 4.0
    assert r["device_ops"][0] == ["k1", 1.25]
    assert r["idle_gaps"][0] == ["record/cudaStreamSynchronize", 1.5]
    assert r["launches"] == 2
