"""Traffic drivers. A traffic mix (``traffic/<name>.json``) names one of
these modules under ``driver``; its ``run(run)`` does the cell's set-up,
measures its window, traces when asked, compares with the reference and
returns a ``harness.Outcome``."""
