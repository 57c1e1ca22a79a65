"""One reader a metric: metrics/<name>.py defines read(run) -> number or
None (nothing to read: the metric is left out of the line).  `run` holds
the window (seconds, count, each item's seconds, set-up seconds) and, in a
traced run, the Trace and the counts taken at the layer boundaries."""
