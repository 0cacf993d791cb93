"""The benchmark harness of gmrm_tpu_torch: inputs, the driven window,
trace reduction, the plain reference and the check that decides
``correct``."""
