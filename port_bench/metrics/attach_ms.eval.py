"""Graph build: the median synchronised host time of ``model.attach_dataset``
(the feature matrix and the adjacency rebuilt with the new nodes) over the
window's rounds."""

import statistics


def read(run):
    times = run.probe.attach_ms
    return statistics.median(times) if times else None
