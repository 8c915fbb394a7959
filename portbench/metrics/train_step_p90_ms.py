"""The 90th percentile (nearest rank) of every request's time in the window."""
from portbench import stats


def read(rec):
    return stats.percentile_ms(rec.latencies, 90)
